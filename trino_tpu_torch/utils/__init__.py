"""Host utilities of the port (the snappy page codec)."""
