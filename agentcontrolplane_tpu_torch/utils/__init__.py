"""Small helpers shared across the port."""
