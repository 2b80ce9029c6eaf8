"""Model stack of the port (dense and MoE families)."""
