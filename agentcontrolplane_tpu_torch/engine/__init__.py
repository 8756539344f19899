"""Serving engine of the port (paged KV, continuous batching)."""
