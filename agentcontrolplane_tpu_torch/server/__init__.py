"""HTTP front door of the port."""
