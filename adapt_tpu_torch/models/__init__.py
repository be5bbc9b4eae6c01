"""Models of the port (the decoder LM so far)."""
