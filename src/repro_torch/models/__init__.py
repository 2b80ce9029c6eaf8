"""Model stack of the port (dense family)."""
