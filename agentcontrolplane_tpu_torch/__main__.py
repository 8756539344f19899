"""``python -m agentcontrolplane_tpu_torch serve --preset llama3-8b --seed 0
--port 8000 [--device cpu] [--quantize-weights] [--quantize-kv]
[--tp N --sp M [--dist-backend gloo|nccl]]`` — serve a preset with random
weights made from ``--seed`` behind the OpenAI-compatible HTTP front door,
optionally with int8 weights and an int8 KV cache (the reference CLI's
``--tpu-quantize-weights`` / ``--tpu-quantize-kv``), and over N x M ranks
(the reference's ``--tpu-tp`` / ``--tpu-sp``): one process per rank, rank 0
answering HTTP. The backend defaults to nccl when the machine has a card per
rank and to gloo when ranks share one card or run on the CPU."""

from __future__ import annotations

import argparse
import logging
import signal
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m agentcontrolplane_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="serve a preset over HTTP")
    s.add_argument("--preset", default="llama3-8b")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.add_argument("--max-slots", type=int, default=8)
    s.add_argument("--max-ctx", type=int, default=2048)
    s.add_argument("--page-size", type=int, default=16)
    s.add_argument("--decode-block", type=int, default=8)
    s.add_argument("--quantize-weights", action="store_true",
                   help="int8 per-output-channel layer weights (weight-only)")
    s.add_argument("--quantize-kv", action="store_true",
                   help="int8 KV pages with per-row-per-head f32 scales "
                        "(relaxes greedy byte identity; accuracy-gated)")
    s.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks (heads, ffn, vocab)")
    s.add_argument("--sp", type=int, default=1,
                   help="context-parallel ranks (a slice of every KV page each)")
    s.add_argument("--dist-backend", choices=("gloo", "nccl"), default=None,
                   help="torch.distributed backend for --tp/--sp (default: nccl with a card "
                        "per rank, else gloo)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from .server.rest import serve, serve_parallel

    engine_kw = dict(
        max_slots=args.max_slots, max_ctx=args.max_ctx, page_size=args.page_size,
        decode_block_size=args.decode_block, quantize_weights=args.quantize_weights,
        quantize_kv=args.quantize_kv,
    )
    # a terminated server exits through its finally blocks: the ranks'
    # launcher then kills every rank it started
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    try:
        if args.tp * args.sp > 1:
            serve_parallel(args.preset, tp=args.tp, sp=args.sp, seed=args.seed, host=args.host,
                           port=args.port, device=args.device, backend=args.dist_backend,
                           **engine_kw)
        else:
            serve(args.preset, seed=args.seed, host=args.host, port=args.port,
                  device=args.device, **engine_kw)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
