#!/usr/bin/env python3
"""Time the port's engine on one CUDA card for one or more source trees,
each in its own process, in the order given (repeat a root to alternate):

    python3 scripts/torch_turns_ab.py . build/parent build/parent .

Each root's ``agentcontrolplane_tpu_torch`` serves llama3-8b in bf16
(random weights from seed 0, 8 slots, a 2048-token context, pages of 16,
decode blocks of 8) and runs:

- decode: a greedy group of 8 requests of 128 tokens, three times; ms per
  decode step (the group's decode wall over its decode steps) and TTFT;
- turns: 4 conversations x 3 turns, each turn's 4 requests admitted as one
  group, a 768-token first prompt and +32 sampled + 64 tool-result tokens a
  turn; TTFT per turn, after one discarded set of conversations has warmed
  every prefill shape up. Where the tree's ``Engine.submit`` takes ``park=``
  the turns park, so turns 2-3 adopt their slots and prefill only their
  suffix; otherwise every turn prefills its whole history.

A root without its own kernel build gets a copy of the first root's (same
sources, same hashed names). One JSON line per run, then a summary line.
"""

from __future__ import annotations

import inspect
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

TURNS, CONVERSATIONS, FIRST, TURN_TOKENS, TOOL = 3, 4, 768, 32, 64


def child(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
    from agentcontrolplane_tpu_torch.ops.cuda import build

    build.build_all()
    engine = Engine("llama3-8b", device="cuda", seed=0, max_slots=8, max_ctx=2048, page_size=16,
                    decode_block_size=8)
    park = "park" in inspect.signature(engine.submit).parameters
    engine.start()
    try:
        engine.generate("warm up", SamplingParams(max_tokens=16))
        decode = []
        for _ in range(3):
            with engine.hold_admission():
                futs = [engine.submit(f"Task {i}: summarize the incident report.",
                                      SamplingParams(max_tokens=128)) for i in range(8)]
                s0 = engine.decode_steps
            res = [f.result(timeout=600) for f in futs]
            steps = engine.decode_steps - s0
            wall = max(r.latency_ms for r in res) - max(r.ttft_ms for r in res)
            decode.append({"ms_per_step": wall / steps, "ttft_ms": max(r.ttft_ms for r in res)})
        for seed in (99, 100):  # the first set warms every prefill shape up
            g = torch.Generator().manual_seed(seed)
            prompts = [torch.randint(0, 256, (FIRST,), generator=g).tolist()
                       for _ in range(CONVERSATIONS)]
            turns = []
            for _ in range(TURNS):
                kw = {"park": True} if park else {}
                with engine.hold_admission():
                    futs = [engine.submit(p, SamplingParams(max_tokens=TURN_TOKENS), **kw)
                            for p in prompts]
                res = [f.result(timeout=600) for f in futs]
                turns.append([r.ttft_ms for r in res])
                prompts = [p + r.tokens + torch.randint(0, 256, (TOOL,), generator=g).tolist()
                           for p, r in zip(prompts, res)]
    finally:
        engine.stop()
    return {"root": root, "park": park, "device": torch.cuda.get_device_name(0),
            "ms_per_step": statistics.median(d["ms_per_step"] for d in decode),
            "decode_runs": decode, "turn_ttft_ms": turns,
            "turn_ttft_median_ms": [statistics.median(t) for t in turns]}


def main(roots: list[str]) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    first_build = Path(roots[0]).resolve() / "build" / "acp_torch_kernels"
    runs = []
    for root in roots:
        target = Path(root).resolve() / "build" / "acp_torch_kernels"
        if first_build.exists() and target != first_build and not target.exists():
            shutil.copytree(first_build, target)
        t0 = time.monotonic()
        out = subprocess.run([sys.executable, __file__, "--child", root], capture_output=True,
                             text=True, timeout=900)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], sep="\n")
            return out.returncode
        doc = json.loads(out.stdout.strip().splitlines()[-1])
        doc["wall_s"] = time.monotonic() - t0
        doc["card"] = card
        runs.append(doc)
        print(json.dumps(doc), flush=True)
    by_root: dict = {}
    for r in runs:
        by_root.setdefault(r["root"], []).append(r)
    print(json.dumps({"card": card, "summary": {
        root: {"ms_per_step": [r["ms_per_step"] for r in rs],
               "turn_ttft_median_ms": [r["turn_ttft_median_ms"] for r in rs]}
        for root, rs in by_root.items()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child(sys.argv[2])))
    else:
        sys.exit(main(sys.argv[1:] or ["."]))
