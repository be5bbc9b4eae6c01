"""The layer-graph IR of the port (``ir``)."""
