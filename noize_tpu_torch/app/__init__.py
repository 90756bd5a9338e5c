"""Application entry points of the port."""
