"""The provider-agnostic chat-completion seam (``base.py``), the client
factory (``factory.py``) and the scriptable mock (``mock.py``)."""
