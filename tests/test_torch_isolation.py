"""The torch port stands alone: no module of ``agentcontrolplane_tpu_torch``
and not ``chip_smoke.py`` imports JAX, the JAX package, or a package the
card's machine lacks (pydantic, aiohttp, safetensors, tokenizers)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {
    "jax", "jaxlib", "agentcontrolplane_tpu", "pydantic", "aiohttp",
    "safetensors", "tokenizers", "ml_dtypes",
}
FILES = sorted((ROOT / "agentcontrolplane_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(source: str) -> set[str]:
    """Top-level package names of every absolute import in ``source``."""
    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_forbidden_imports(path):
    assert not (_imports(path.read_text()) & FORBIDDEN), path


def test_scan_covers_the_port_and_catches_offenders():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for expected in (
        "agentcontrolplane_tpu_torch/models/llama.py",
        "agentcontrolplane_tpu_torch/ops/cuda/paged_attention.py",
        "agentcontrolplane_tpu_torch/ops/quant.py",
        "agentcontrolplane_tpu_torch/engine/accuracy.py",
        "agentcontrolplane_tpu_torch/engine/engine.py",
        "agentcontrolplane_tpu_torch/server/rest.py",
        "chip_smoke.py",
    ):
        assert expected in names
    assert "jax" in _imports("def f():\n    from jax import numpy as jnp\n")
    assert "agentcontrolplane_tpu" in _imports("import agentcontrolplane_tpu.ops.paged\n")
    assert not _imports("from .engine import Engine\n")  # relative imports stay inside
