"""``python -m agentcontrolplane_tpu_torch <command>``: the port's command
line; ``cli.py`` lists the commands (``run``, ``apply``, ``get``, ``task``,
``approvals``, ``contacts``, ``chat``, ``serve``, ...)."""

from __future__ import annotations

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
