"""Where the paged walk's time goes, measured on the card by switching parts
of it off.

    python3 -m agentcontrolplane_tpu_torch.ops.cuda.walk_parts

Copies ``csrc/`` into ``build/acp_walk_parts/<variant>/`` (git-ignored),
switches off the f32 math of the tile loop, the ``cp.async`` loads and/or
the cross-split merge by editing the copy (each behind a condition that is
false at run time, so everything else compiles as it is), builds every
variant's f32/bf16 walk with ``nvcc`` at once, and times mode 1 of each by
CUDA-graph replay at the llama3-8b decode shapes: one card (8 slots, 32/8
heads, lengths 0..2048), one tp=2 rank (16/4 heads), short serving lengths,
one lane of 2048 tokens split as the wrapper splits it and unsplit. A
variant's output is garbage; only its time means anything. Measurement
only: nothing on the serving path imports this module.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import torch

from . import build
from . import paged_attention as pa

OUT = build.BUILD_DIR.parent / "acp_walk_parts"
MATH = "    // logits of this group's RPG rows, then one rescale, then the values\n"
LOOP_END = "  }\n  cp_async_wait<0>();"
LOADS = "  auto fill = [&](int tile) {\n    if (tile < n_tiles) {"
MERGE = "  if (n_live > 1) {"
# name -> (math, loads, merge)
VARIANTS = {
    "whole": (True, True, True), "no-math": (False, True, True),
    "no-loads": (True, False, True), "no-merge": (True, True, False),
    "no-math-no-loads": (False, False, True), "none": (False, False, False),
}
LLAMA_LENS = [0, 1, 17, 255, 1024, 1500, 2047, 2048]
CASES = {  # name -> (H, H_kv, seq_lens, split along pages)
    "one-card": (32, 8, LLAMA_LENS, True), "tp2-rank": (16, 4, LLAMA_LENS, True),
    "serving": (32, 8, [61, 64, 70, 77, 85, 90, 96, 110], True),
    "one-lane": (32, 8, [2048], True), "one-lane-unsplit": (32, 8, [2048], False),
}


def patched(src: str, math: bool, loads: bool, merge: bool) -> str:
    """The kernel header with the parts switched off (``H < 0`` is false
    at run time, so the compiler keeps the code but no block runs it)."""
    for part, anchor in (("math", MATH), ("loop end", LOOP_END), ("loads", LOADS),
                         ("merge", MERGE)):
        if anchor not in src:
            raise RuntimeError(f"walk_parts: the {part} anchor is not in the header")
    if not math:
        src = src.replace(MATH, MATH + "    if (H < 0) {\n")
        src = src.replace(LOOP_END, "    }\n" + LOOP_END)
    if not loads:
        src = src.replace(LOADS, LOADS.replace("(tile < n_tiles)", "(H < 0 && tile < n_tiles)"))
    if not merge:
        src = src.replace(MERGE, "  if (z > 0 && H > 0) return;\n  if (H < 0 && n_live > 1) {")
    return src


def build_variants() -> dict[str, ctypes.CDLL]:
    shutil.rmtree(OUT, ignore_errors=True)
    nvcc = build.nvcc_path()
    procs = {}
    for name, parts in VARIANTS.items():
        d = OUT / name
        shutil.copytree(build.CSRC, d)
        header = d / "paged_attention.cuh"
        header.write_text(patched(header.read_text(), *parts))
        cmd = [nvcc, *build.NVCC_FLAGS, "-o", str(d / "walk.so"), str(d / "paged_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"walk_parts: nvcc failed for {name}:\n{text}")
    return {name: ctypes.CDLL(str(OUT / name / "walk.so")) for name in VARIANTS}


def graph_us(fn, calls: int = 32, replays: int = 10) -> float:
    """Device microseconds per call: ``calls`` calls in one CUDA graph,
    replayed between CUDA events."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (replays * calls)


def case_fn(H: int, H_kv: int, lens: list[int], P: int = 16, max_pages: int = 128,
            layers: int = 4):
    """Mode 1 of the walk on random bf16 pools (``layers`` of them cycled,
    so the pages come from device memory, not L2), tables of distinct
    pages."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    S, num_pages = len(lens), len(lens) * max_pages + 1
    perm = torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(0)) + 1
    tables = torch.zeros(S, max_pages, dtype=torch.int32)
    for s, n in enumerate(lens):
        used = -(-n // P)
        tables[s, :used] = perm[s * max_pages: s * max_pages + used].to(torch.int32)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k_new, v_new = randn(S, H, 128), randn(S, H_kv, 128), randn(S, H_kv, 128)
    k, v = randn(layers, num_pages, P, H_kv, 128), randn(layers, num_pages, P, H_kv, 128)
    bt, sl = tables.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev)
    return lambda i: pa.paged_decode_attention_cache_plus_new(
        q, k[i % layers], v[i % layers], bt, sl, k_new, v_new)


def main() -> int:
    if not torch.cuda.is_available():
        print("walk_parts: needs a CUDA card", file=sys.stderr)
        return 1
    libs = build_variants()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    card = card[0] if card else torch.cuda.get_device_name(0)
    waves = pa.WAVES
    print(f"walk_parts: mode 1, bf16, d=128, pages of 16, 128-page tables; us per call [{card}]")
    for name, lib in libs.items():
        build._loaded["paged_attention"] = lib
        row = []
        for case, (H, H_kv, lens, split) in CASES.items():
            pa.WAVES = waves if split else 0  # no waves to fill: one split
            row.append(f"{case} {graph_us(case_fn(H, H_kv, lens)):.1f}")
        pa.WAVES = waves
        print(f"  {name:17s} " + " | ".join(row), flush=True)
    build._loaded.pop("paged_attention", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
