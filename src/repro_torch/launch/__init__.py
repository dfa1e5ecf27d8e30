"""Entry points of the port (training)."""
