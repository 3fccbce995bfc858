"""Host runtime of the port: the fusion session."""
