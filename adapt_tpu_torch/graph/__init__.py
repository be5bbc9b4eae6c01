"""The layer-graph IR of the port (``ir``), its partitioner
(``partition``) and its architecture-by-value specs (``spec``)."""
