"""Tensor ops of the port: plain PyTorch, plus ``ops.cuda`` for the
hand-written kernels (built at first use on the card)."""
