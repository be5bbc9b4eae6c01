"""Serving runtime of the port (the dense continuous batcher so far)."""
