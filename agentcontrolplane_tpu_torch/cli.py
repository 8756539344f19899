"""The port's command line (``python -m agentcontrolplane_tpu_torch``): the
operator and kubectl-style resource management, as the reference's
``acp-tpu`` (``agentcontrolplane_tpu/cli.py``), plus the engine's own
front door (``serve``):

  run [--db state.db] [--port 8082] [--tpu-preset llama3-8b] [--tpu-kv-layout slot]
      [--tpu-park-max-s 30]
      [--tpu-prefill-chunk 0] [--tpu-token-budget 0] [--tpu-prefix-dedup 1]
      [--tpu-megastep 1] [--tpu-rate-planner 1] [--tpu-autopilot 0] [--tpu-spec-len 0]
      [--tpu-spec-ngram 3] [--tpu-host-kv-bytes 0] [--tpu-host-prefetch 1] [--device cpu]
  apply -f manifests.yaml
  get <Kind> [name] [-o yaml]
  delete <Kind> <name>
  events
  approvals [approve|reject <call-id> [--comment ...]]
  contacts [respond <call-id> <text>]
  task create <agent> <message> [--follow]
  task show <name>
  engine
  perf [--json] [--top 20]
  timeline [<rid>] [--last 50]
  trace export [-o trace.json]
  chat [--system ...]
  serve --preset llama3-8b [--tp N --sp M]

Every command but ``run`` and ``serve`` is an HTTP call to the operator's
REST API at ``--server`` (``$ACP_TPU_SERVER``, default
``http://127.0.0.1:8082``) with ``--token`` (``$ACP_API_TOKEN``) as the
bearer token, over the standard library (the card's machine has no httpx).
``run`` builds its engine on the card unless ``--device cpu`` is given and
raises without CUDA. ``--tpu-kv-layout`` has the reference's default,
``slot`` (the plain-torch slot rows); ``paged`` serves the page pool the
hand-written CUDA walk reads. Not served yet: checkpoints and LoRA
(``--tpu-checkpoint``, ``--tpu-lora``; ROADMAP A.9, A.15), the served store
(A.12), prewarm (``--tpu-prewarm``; A.3), tp/sp/ep and multi-host serving
(``--tpu-tp/--tpu-sp/--tpu-ep``; A.14), ``trace export --fleet`` and the
``fleet``, ``replay``, ``chaos`` (A.12), ``engine-follower`` (A.14) and
``train`` (A.15) commands.
"""

from __future__ import annotations

import argparse
import asyncio
import http.client
import json
import logging
import os
import signal
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional

DEFAULT_SERVER = os.environ.get("ACP_TPU_SERVER", "http://127.0.0.1:8082")


class _Response:
    def __init__(self, status_code: int, text: str):
        self.status_code, self.text = status_code, text

    def json(self) -> Any:
        return json.loads(self.text)


class _Client:
    """A small JSON client for the REST API (``urllib``)."""

    def __init__(self, server: str, token: Optional[str], timeout: float = 30.0):
        self.server = server.rstrip("/")
        self.timeout = timeout
        self.headers = {"Authorization": f"Bearer {token}"} if token else {}

    def request(self, method: str, path: str, body: Any = None, content: Optional[str] = None,
                params: Optional[dict] = None) -> _Response:
        url = self.server + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        headers = dict(self.headers)
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        elif content is not None:
            data = content.encode()
        req = urllib.request.Request(url, data=data, headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return _Response(resp.status, resp.read().decode())
        except urllib.error.HTTPError as e:
            return _Response(e.code, e.read().decode())

    def get(self, path: str, **kw) -> _Response:
        return self.request("GET", path, **kw)

    def post(self, path: str, **kw) -> _Response:
        return self.request("POST", path, **kw)

    def delete(self, path: str, **kw) -> _Response:
        return self.request("DELETE", path, **kw)


def _client(args) -> _Client:
    token = getattr(args, "token", None) or os.environ.get("ACP_API_TOKEN")
    return _Client(args.server, token)


# -- run / serve --------------------------------------------------------------


def cmd_run(args) -> int:
    from .operator import Operator, OperatorOptions, serve_until_signalled

    logging.basicConfig(level=os.environ.get("ACP_TPU_LOG_LEVEL", "INFO"))
    engine = None
    if args.tpu_preset:
        from .engine.engine import Engine

        engine = Engine(args.tpu_preset, device=args.device, seed=args.seed,
                        kv_layout=args.tpu_kv_layout,
                        max_slots=args.tpu_slots, max_ctx=args.tpu_ctx,
                        max_queue=args.tpu_max_queue,
                        quantize_weights=args.tpu_quantize_weights,
                        quantize_kv=args.tpu_quantize_kv,
                        park_max_s=args.tpu_park_max_s,
                        prefill_chunk=args.tpu_prefill_chunk,
                        token_budget=args.tpu_token_budget,
                        host_kv_bytes=args.tpu_host_kv_bytes,
                        host_prefetch=bool(args.tpu_host_prefetch),
                        prefix_dedup=bool(args.tpu_prefix_dedup),
                        megastep=bool(args.tpu_megastep),
                        rate_planner=bool(args.tpu_rate_planner),
                        autopilot=bool(args.tpu_autopilot),
                        spec_len=args.tpu_spec_len, spec_ngram=args.tpu_spec_ngram)
        engine.start()
    options = OperatorOptions(
        db_path=args.db,
        identity=args.identity or f"acp-tpu-{os.getpid()}",
        leader_election=args.leader_elect,
        api_port=args.port,
        api_host=args.host,
        api_token=args.api_token,
        tls_cert_path=args.tls_cert,
        tls_key_path=args.tls_key,
        tls_client_ca_path=args.tls_client_ca,
        engine=engine,
    )

    async def main() -> None:
        op = Operator(options)
        await op.start()
        try:
            port = args.port
            if not args.leader_elect:  # a follower binds only once it leads
                for _ in range(500):
                    if op.rest_server.bound_port:
                        port = op.rest_server.bound_port
                        break
                    await asyncio.sleep(0.01)
            print(f"operator running; REST API on :{port}", flush=True)
            await serve_until_signalled()
            print("shutting down", flush=True)
        finally:
            await op.stop()
            if engine is not None:
                engine.stop()

    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass
    return 0


def cmd_serve(args) -> int:
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


# -- resources ----------------------------------------------------------------


def cmd_apply(args) -> int:
    with open(args.filename) as f:
        text = f.read()
    resp = _client(args).post("/v1/apply", content=text)
    if resp.status_code != 200:
        print(f"error: {resp.text}", file=sys.stderr)
        return 1
    for item in resp.json():
        print(f"{item['kind'].lower()}/{item['name']} {item['action']}")
    return 0


def cmd_get(args) -> int:
    from .api.yamlsubset import dump_all

    http = _client(args)
    path = f"/v1/resources/{args.kind}" + (f"/{args.name}" if args.name else "")
    resp = http.get(path)
    if resp.status_code != 200:
        print(f"error: {resp.text}", file=sys.stderr)
        return 1
    docs = [resp.json()] if args.name else resp.json()
    if args.output == "yaml":
        print(dump_all(docs), end="")
        return 0
    rows = [
        (
            d["metadata"]["name"],
            (d.get("status") or {}).get("phase") or (d.get("status") or {}).get("status", ""),
            (d.get("status") or {}).get("status_detail", "")[:60],
        )
        for d in docs
    ]
    width = max([len(r[0]) for r in rows], default=4) + 2
    print(f"{'NAME':<{width}}{'STATUS':<14}DETAIL")
    for name, status, detail in rows:
        print(f"{name:<{width}}{status:<14}{detail}")
    return 0


def cmd_delete(args) -> int:
    resp = _client(args).delete(f"/v1/resources/{args.kind}/{args.name}")
    if resp.status_code != 200:
        print(f"error: {resp.text}", file=sys.stderr)
        return 1
    print(f"{args.kind.lower()}/{args.name} deleted")
    return 0


def cmd_events(args) -> int:
    for e in _client(args).get("/v1/events").json():
        print(f"{e['type']:<8}{e['reason']:<28}{e['involved']:<36}{e['message']}")
    return 0


# -- the human steps ----------------------------------------------------------


def cmd_approvals(args) -> int:
    http = _client(args)
    if args.action == "list" or args.action is None:
        for a in http.get("/v1/approvals").json():
            print(f"{a['callId']:<16}{a['fn']:<32}{json.dumps(a['kwargs'])[:60]}")
        return 0
    if not args.call_id:
        print("error: approvals approve/reject requires a call-id", file=sys.stderr)
        return 2
    resp = http.post(f"/v1/approvals/{args.call_id}/{args.action}",
                     params={"comment": args.comment or ""})
    print(resp.json() if resp.status_code == 200 else resp.text)
    return 0 if resp.status_code == 200 else 1


def cmd_contacts(args) -> int:
    http = _client(args)
    if args.action == "list" or args.action is None:
        for c in http.get("/v1/contacts").json():
            print(f"{c['callId']:<16}{c['message'][:80]}")
        return 0
    if not args.call_id or args.text is None:
        print("error: contacts respond requires <call-id> <text>", file=sys.stderr)
        return 2
    resp = http.post(f"/v1/contacts/{args.call_id}/respond", body={"response": args.text})
    print(resp.json() if resp.status_code == 200 else resp.text)
    return 0 if resp.status_code == 200 else 1


# -- tasks --------------------------------------------------------------------


def cmd_task_create(args) -> int:
    """Create a Task; with ``--follow``, poll it (one GET every 0.5 s, so
    no server thread waits on it) until FinalAnswer or Failed."""
    http = _client(args)
    resp = http.post("/v1/tasks", body={"agentName": args.agent, "userMessage": args.message})
    if resp.status_code != 201:
        print(f"error: {resp.text}", file=sys.stderr)
        return 1
    task = resp.json()
    print(f"task/{task['name']} created")
    if not args.follow:
        return 0
    last_phase = ""
    while True:
        resp = http.get(f"/v1/tasks/{task['name']}")
        if resp.status_code != 200:
            print(f"error: {resp.text}", file=sys.stderr)
            return 1
        t = resp.json()
        if t["phase"] != last_phase:
            print(f"  phase: {t['phase']}  {t.get('statusDetail', '')}")
            last_phase = t["phase"]
        if t["phase"] in ("FinalAnswer", "Failed"):
            print(t.get("output") or t.get("error", ""))
            return 0 if t["phase"] == "FinalAnswer" else 1
        time.sleep(0.5)


def cmd_task_show(args) -> int:
    """Print a task's checkpointed conversation (its execution state)."""
    resp = _client(args).get(f"/v1/tasks/{args.name}")
    if resp.status_code != 200:
        print(f"error: {resp.text}", file=sys.stderr)
        return 1
    t = resp.json()
    print(f"task/{t['name']}  agent={t['agentName']}  phase={t['phase']}  {t['statusDetail']}")
    for m in t["contextWindow"]:
        role = m["role"].upper()
        content = m.get("content", "")
        if content:
            print(f"  [{role}] {content if len(content) <= 200 else content[:197] + '...'}")
        if m.get("tool_calls"):
            calls = ", ".join(f"{tc['function']['name']}({tc['function']['arguments']})"
                              for tc in m["tool_calls"])
            print(f"  [{role}] -> {calls}")
        if not content and not m.get("tool_calls"):
            print(f"  [{role}]")
    if t.get("error"):
        print(f"  ERROR: {t['error']}")
    return 0


# -- the engine ---------------------------------------------------------------


def cmd_engine(args) -> int:
    resp = _client(args).get("/v1/engine")
    if resp.status_code != 200:
        print(f"error: {resp.text}", file=sys.stderr)
        return 1
    print(json.dumps(resp.json(), indent=2))
    return 0


def cmd_perf(args) -> int:
    """The dispatch profiler: per-program dispatch telemetry (where the
    device time goes, how much of each dispatch is padding), first
    dispatches after prewarm, and the goodput/waste ledger (token positions
    computed against committed, the waste by cause)."""
    resp = _client(args).get("/v1/engine/perf")
    if resp.status_code != 200:
        print(f"error: {resp.text}", file=sys.stderr)
        return 1
    doc = resp.json()
    if args.json:
        print(json.dumps(doc, indent=2))
        return 0
    g = doc.get("goodput", {})
    computed = g.get("computed", 0)
    print(
        f"goodput: {g.get('goodput', 0)}/{computed} token positions "
        f"({g.get('ratio', 1.0):.1%}); profiler "
        f"{'enabled' if doc.get('enabled') else 'DISABLED'}, "
        f"prewarmed={doc.get('prewarmed')}"
    )
    waste = {k: v for k, v in g.get("waste", {}).items() if v}
    if waste:
        print("waste by cause:")
        for cause, n in sorted(waste.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * n / computed if computed else 0.0
            print(f"  {cause:<18}{n:>12}  ({pct:.1f}%)")
    cold = doc.get("cold_compiles", {})
    if cold.get("serving"):
        print(f"SERVING-TIME COLD COMPILES: {cold['serving']} "
              "(each was a latency stall — widen prewarm coverage)")
        for ev in cold.get("events", []):
            print(f"  {ev['program']:<34}{ev['wall_s'] * 1e3:>10.1f}ms")
    programs = doc.get("programs", {})
    if programs:
        print(f"{'PROGRAM':<34}{'N':>7}{'HOST ms':>10}{'DEV ms':>10}"
              f"{'PAD%':>7}  TOKENS")
        for key, p in list(programs.items())[: args.top]:
            dev = p.get("device_ms_mean")
            print(
                f"{key:<34}{p['dispatches']:>7}"
                f"{p['host_ms_mean']:>10.3f}"
                f"{dev if dev is not None else float('nan'):>10.3f}"
                f"{p['padding_pct']:>7.1f}  {p['real_tokens']}"
            )
    return 0


def _print_flight_event(e: dict, rel_key: str | None = None) -> None:
    stamp = (
        f"+{e[rel_key] * 1e3:9.1f}ms" if rel_key and rel_key in e
        else f"t={e['t']:.3f}"
    )
    who = e.get("rid", "-")
    slot = f"slot {e['slot']}" if "slot" in e else ""
    detail = ""
    if e.get("detail"):
        detail = " ".join(f"{k}={v}" for k, v in e["detail"].items())
    print(f"  {stamp}  {e['kind']:<20}{who:<10}{slot:<9}{detail}")


def cmd_timeline(args) -> int:
    """The flight recorder: with a request id, that request's decisions
    (admit, chunks, preempts, park and adopt, finish) with its phase
    latencies; without one, the recent window and the request ids whose
    timelines are queryable."""
    http = _client(args)
    if not args.request_id:
        resp = http.get("/v1/engine/flight", params={"last": str(args.last)})
        if resp.status_code != 200:
            print(f"error: {resp.text}", file=sys.stderr)
            return 1
        doc = resp.json()
        print(
            f"flight recorder: {doc['window_events']}/{doc['capacity']} "
            f"events windowed, {doc['recorded_total']} recorded total, "
            f"enabled={doc['enabled']}"
        )
        if doc.get("request_ids"):
            print("recent request ids: " + " ".join(doc["request_ids"]))
        for e in doc["events"]:
            _print_flight_event(e)
        return 0
    resp = http.get(f"/v1/requests/{args.request_id}/timeline")
    if resp.status_code != 200:
        print(f"error: {resp.text}", file=sys.stderr)
        return 1
    doc = resp.json()
    print(f"request {doc['request_id']}  total {doc['total_s'] * 1e3:.1f}ms")
    for e in doc["events"]:
        _print_flight_event(e, rel_key="t_rel")
    if doc.get("phases"):
        print("phases (sum ~ end-to-end; tool_overlap_hidden overlaps decode):")
        for phase, dur in doc["phases"].items():
            print(f"  {phase:<22}{dur * 1e3:>10.1f}ms")
    if doc.get("rate_plan"):
        rp = doc["rate_plan"]
        print(
            f"rate plan: quota {rp['quota']} chunk(s)/cycle, "
            f"{rp['reprojections']} reprojection(s); actual "
            f"{rp['chunks_dispatched']} chunks / {rp['chunk_tokens']} "
            f"tokens over {rp['prefill_span_s'] * 1e3:.1f}ms"
        )
        for pr in rp["projections"]:
            print(
                f"  {pr['reason']:<8} quota={pr['quota']} "
                f"tokens_left={pr['tokens_left']} "
                f"seconds_left={pr['seconds_left']}"
            )
    return 0


def cmd_trace_export(args) -> int:
    """Pull the anonymized workload trace off a running server
    (``/v1/engine/trace``). The document is validated before it is written,
    so an export this command exits 0 on loads in the replayer. The fleet's
    stitched trace comes with the fleet (ROADMAP A.12)."""
    from .observability.trace_export import validate_trace

    path = "/v1/engine/trace"
    resp = _client(args).get(path)
    if resp.status_code != 200:
        print(
            f"error: GET {path} -> {resp.status_code}: {resp.text[:200]}",
            file=sys.stderr,
        )
        return 1
    doc = resp.json()
    problems = validate_trace(doc)
    if problems:
        print("error: server returned an unreplayable trace:", file=sys.stderr)
        for problem in problems[:10]:
            print(f"  {problem}", file=sys.stderr)
        return 1
    payload = json.dumps(doc, indent=2, sort_keys=True)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(payload + "\n")
        summary = (
            f"wrote {args.output}: {len(doc['requests'])} request(s) over "
            f"{doc.get('span_s', 0.0):.3f}s from {doc.get('source')}"
        )
        if not doc.get("complete", True):
            summary += "  [INCOMPLETE: recorder evicted timelines mid-window]"
        print(summary)
    else:
        print(payload)
    return 0


def _post_stream(server: str, token: Optional[str], payload: dict):
    """POST a streamed chat completion (``http.client``, no timeout) ->
    (connection, response); the caller reads the SSE lines and closes."""
    url = urllib.parse.urlsplit(server)
    conn_cls = http.client.HTTPSConnection if url.scheme == "https" else http.client.HTTPConnection
    conn = conn_cls(url.hostname, url.port or (443 if url.scheme == "https" else 80))
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    conn.request("POST", url.path.rstrip("/") + "/v1/chat/completions",
                 body=json.dumps(payload).encode(), headers=headers)
    return conn, conn.getresponse()


def cmd_chat(args) -> int:
    """A REPL against the operator's OpenAI-compatible chat route, streamed
    (SSE): the quickest way to poke the engine by hand."""
    token = getattr(args, "token", None) or os.environ.get("ACP_API_TOKEN")
    messages: list[dict] = []
    if args.system:
        messages.append({"role": "system", "content": args.system})
    print("chatting with the engine; empty line or Ctrl-D to exit", flush=True)
    while True:
        try:
            line = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            print(flush=True)
            return 0
        if not line:
            return 0
        messages.append({"role": "user", "content": line})
        payload = {"messages": messages, "max_tokens": args.max_tokens,
                   "temperature": args.temperature, "stream": True}
        reply: list[str] = []
        errored = False
        conn = None
        try:
            conn, resp = _post_stream(args.server, token, payload)
            if resp.status != 200:
                print(f"error: {resp.read().decode()}", file=sys.stderr)
                messages.pop()
                continue
            for line in resp:
                raw = line.decode().rstrip("\r\n")
                if not raw.startswith("data: ") or raw == "data: [DONE]":
                    continue
                event = json.loads(raw[len("data: "):])
                if "error" in event:
                    print(f"\nerror: {event['error']['message']}", file=sys.stderr)
                    errored = True
                    break
                delta = event["choices"][0]["delta"]
                chunk = delta.get("content") or ""
                if chunk:
                    reply.append(chunk)
                    print(chunk, end="", flush=True)
                for tc in delta.get("tool_calls") or []:
                    print(f"\n[tool call] {tc['function']['name']}"
                          f"({tc['function']['arguments']})", flush=True)
        except (OSError, http.client.HTTPException, KeyboardInterrupt) as e:
            print(f"\nerror: {e}", file=sys.stderr)
            errored = True
        finally:
            if conn is not None:
                conn.close()
        if errored:
            # drop the failed exchange, so the next turn's conversation
            # holds no partial assistant turn
            messages.pop()
            continue
        print(flush=True)
        messages.append({"role": "assistant", "content": "".join(reply)})


# -- the parser ---------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m agentcontrolplane_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--server", default=DEFAULT_SERVER, help="operator REST URL")
    p.add_argument("--token", default=None,
                   help="bearer token for the REST API (default: $ACP_API_TOKEN)")
    sub = p.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="run the operator and its REST API")
    run.add_argument("--db", default=None, help="sqlite state path (default: in-memory)")
    run.add_argument("--port", type=int, default=8082, help="REST port (0: a free one)")
    run.add_argument("--host", default="127.0.0.1",
                     help="REST bind address (0.0.0.0 inside containers)")
    run.add_argument("--identity", default=None)
    run.add_argument("--leader-elect", action="store_true")
    run.add_argument("--api-token", default=os.environ.get("ACP_API_TOKEN", ""),
                     help="require this bearer token on the REST API (default: $ACP_API_TOKEN)")
    run.add_argument("--tls-cert", default=os.environ.get("ACP_TLS_CERT") or None,
                     help="serve the REST API over HTTPS with this certificate (PEM); "
                          "rotated files are picked up without restart")
    run.add_argument("--tls-key", default=os.environ.get("ACP_TLS_KEY") or None,
                     help="private key (PEM) for --tls-cert")
    run.add_argument("--tls-client-ca", default=os.environ.get("ACP_TLS_CLIENT_CA") or None,
                     help="require client certificates signed by this CA (mTLS)")
    run.add_argument("--tpu-preset", default=None,
                     help="serve a model preset (random weights from --seed) for provider: tpu")
    run.add_argument("--tpu-kv-layout", choices=["slot", "paged"], default="slot")
    run.add_argument("--tpu-slots", type=int, default=64)
    run.add_argument("--tpu-ctx", type=int, default=2048)
    run.add_argument("--tpu-max-queue", type=int, default=0,
                     help="admission-queue cap (beyond it a request is shed with 503 + "
                          "Retry-After); 0 = unbounded")
    run.add_argument("--tpu-quantize-weights", "--quantize-weights", action="store_true",
                     help="int8 per-output-channel layer weights (weight-only)")
    run.add_argument("--tpu-quantize-kv", "--quantize-kv", action="store_true",
                     help="int8 KV pages with per-row-per-head f32 scales")
    run.add_argument("--tpu-park-max-s", type=float, default=30.0,
                     help="seconds a slot parked at generation end (prompt KV resident) "
                          "waits for the conversation's next turn before it is released; "
                          "0 disables parking")
    run.add_argument(
        "--tpu-spec-len", type=int, default=0,
        help="speculative decoding: max draft tokens verified per decode "
        "dispatch via n-gram prompt lookup (greedy outputs stay "
        "byte-identical; see docs/serving-engine.md); 0 = off",
    )
    run.add_argument(
        "--tpu-spec-ngram", type=int, default=3,
        help="longest n-gram the prompt-lookup drafter matches on",
    )
    run.add_argument(
        "--tpu-prefill-chunk", type=int, default=0,
        help="chunked prefill: split every prefill into chunks of at most "
        "this many tokens, co-scheduled with decode under the unified "
        "token-budget scheduler so one long prompt can't head-of-line-block "
        "decoding slots (greedy outputs byte-identical on/off; see "
        "docs/serving-engine.md); 0 = off (whole prefill at admission)",
    )
    run.add_argument(
        "--tpu-token-budget", type=int, default=0,
        help="per-dispatch-cycle token budget the scheduler spends across "
        "prefill chunks + decode + speculative verify; 0 = auto-sized "
        "(decode always dispatches, one chunk per mid-prefill slot rides "
        "along); only meaningful with --tpu-prefill-chunk",
    )
    run.add_argument(
        "--tpu-host-kv-bytes", type=int, default=0,
        help="host-RAM KV offload tier budget in bytes: preemption, park "
        "expiry, and mid-prefill deadline drops swap their written KV to "
        "host RAM and re-admission swaps it back instead of re-running "
        "prefill (greedy outputs byte-identical; see docs/serving-engine.md "
        "'KV memory tiers'); 0 = off (discard and recompute)",
    )
    run.add_argument(
        "--tpu-host-prefetch", type=int, default=1,
        help="async host-KV prefetch (paged layout): stage the NEXT "
        "restore chunk's host->device copies a cycle early so the scatter "
        "commit rides the dispatch window instead of blocking the engine "
        "thread (byte-identical on or off; "
        "acp_engine_kv_prefetch_commits_total counts the overlap); "
        "1 = on (default), 0 = blocking swap-ins",
    )
    run.add_argument(
        "--tpu-prefix-dedup", type=int, default=1,
        help="cross-request shared-prefix page dedup (paged KV layout): "
        "requests whose page-aligned prompt prefix matches a live slot "
        "refcount-share its pages instead of materializing a private copy "
        "— N concurrent tasks on one agent persona hold 1 copy, not N; "
        "0 disables (byte-identical either way)",
    )
    run.add_argument(
        "--tpu-megastep", type=int, default=1,
        help="fused megastep dispatch: a busy chunked cycle's prefill "
        "chunks + final-chunk continuations + decode block (or spec "
        "verify) compile into ONE program, so the steady-state cycle "
        "issues a single device dispatch (greedy outputs byte-identical "
        "on/off; see docs/megastep.md); 0 = the split per-phase dispatches",
    )
    run.add_argument(
        "--tpu-rate-planner", type=int, default=1,
        help="admission-time chunk-rate planner: deadline requests get a "
        "per-cycle chunk quota (tokens remaining / cycles until deadline, "
        "reprojected on preempt-resume and park-adopt) instead of the "
        "flat one-chunk cadence — deadlines met by arithmetic, not EDF "
        "luck (see docs/megastep.md); 0 = flat cadence",
    )
    run.add_argument(
        "--tpu-autopilot", type=int, default=0,
        help="scheduler autopilot: steer --tpu-prefill-chunk / "
        "--tpu-token-budget / --tpu-spec-len one bounded step at a time "
        "from observed phase attribution, budget utilization and "
        "speculative acceptance (see docs/megastep.md); 0 = off",
    )
    run.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    run.set_defaults(fn=cmd_run)

    ap = sub.add_parser("apply", help="apply manifests (YAML or JSON)")
    ap.add_argument("-f", "--filename", required=True)
    ap.set_defaults(fn=cmd_apply)

    get = sub.add_parser("get", help="get resources")
    get.add_argument("kind")
    get.add_argument("name", nargs="?")
    get.add_argument("-o", "--output", choices=["table", "yaml"], default="table")
    get.set_defaults(fn=cmd_get)

    de = sub.add_parser("delete", help="delete a resource")
    de.add_argument("kind")
    de.add_argument("name")
    de.set_defaults(fn=cmd_delete)

    ev = sub.add_parser("events", help="execution history")
    ev.set_defaults(fn=cmd_events)

    apr = sub.add_parser("approvals", help="pending human approvals")
    apr.add_argument("action", nargs="?", choices=["list", "approve", "reject"])
    apr.add_argument("call_id", nargs="?")
    apr.add_argument("--comment", default="")
    apr.set_defaults(fn=cmd_approvals)

    con = sub.add_parser("contacts", help="pending human contacts")
    con.add_argument("action", nargs="?", choices=["list", "respond"])
    con.add_argument("call_id", nargs="?")
    con.add_argument("text", nargs="?")
    con.set_defaults(fn=cmd_contacts)

    task = sub.add_parser("task", help="task operations")
    tsub = task.add_subparsers(dest="task_command", required=True)
    tc = tsub.add_parser("create")
    tc.add_argument("agent")
    tc.add_argument("message")
    tc.add_argument("--follow", action="store_true")
    tc.set_defaults(fn=cmd_task_create)
    ts = tsub.add_parser("show", help="print a task's conversation")
    ts.add_argument("name")
    ts.set_defaults(fn=cmd_task_show)

    eng = sub.add_parser("engine", help="engine status")
    eng.set_defaults(fn=cmd_engine)

    pf = sub.add_parser(
        "perf",
        help="compute efficiency observatory: per-program dispatch "
        "telemetry, cold compiles, goodput/waste accounting",
    )
    pf.add_argument("--json", action="store_true", help="raw JSON payload")
    pf.add_argument(
        "--top", type=int, default=20,
        help="program rows to show (sorted by total host time)",
    )
    pf.set_defaults(fn=cmd_perf)

    tl = sub.add_parser(
        "timeline",
        help="flight recorder: a request's lifecycle timeline (or, with no "
        "id, the recent engine decision window)",
    )
    tl.add_argument("request_id", nargs="?", help="engine request id (rid)")
    tl.add_argument(
        "--last", type=int, default=50,
        help="window events to show when no request id is given",
    )
    tl.set_defaults(fn=cmd_timeline)

    trc = sub.add_parser(
        "trace",
        help="anonymized replayable workload traces (flight recorder export)",
    )
    trsub = trc.add_subparsers(dest="trace_command", required=True)
    te = trsub.add_parser("export", help="export the engine's workload trace as validated JSON")
    te.add_argument(
        "-o", "--output", default=None,
        help="write the trace here (default: stdout)",
    )
    te.set_defaults(fn=cmd_trace_export)

    chat = sub.add_parser("chat", help="interactive chat with the engine (SSE)")
    chat.add_argument("--system", default="")
    chat.add_argument("--max-tokens", type=int, default=256)
    chat.add_argument("--temperature", type=float, default=0.7)
    chat.set_defaults(fn=cmd_chat)

    s = sub.add_parser("serve", help="serve a preset over HTTP (the engine's front door alone)")
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
    s.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
