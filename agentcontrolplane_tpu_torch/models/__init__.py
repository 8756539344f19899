"""Model programs of the port (the Llama family)."""
