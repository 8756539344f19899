"""The provider-agnostic chat-completion seam (``base.py``)."""
