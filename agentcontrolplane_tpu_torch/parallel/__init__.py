"""Parallel serving over ``torch.distributed``: one process per rank
(``distributed.py``) and the tensor/context-parallel serving group with its
slicing rules (``mesh.py``) — the counterparts of the JAX package's
``parallel/distributed.py`` and ``parallel/mesh.py``."""
