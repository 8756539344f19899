"""The port's CLI against the JAX package's, on the CPU.

The live-server flow of the reference's ``tests/server/test_manifests_cli.py``
(``apply -f``, ``get``, ``get -o yaml``, ``task create --follow``,
``events``, ``task show``, ``task show ghost``, ``engine``, ``delete``)
runs through each package's ``main([...])`` against that package's own
operator (REST on an ephemeral port, ``MockLLMClient`` answering "Paris"),
and so do the human steps (``approvals``, ``approve``/``reject``,
``contacts``, ``contacts respond``), the bearer token (``--token``),
``chat`` and the engine's ``perf``, ``timeline`` and ``trace export`` over
a tiny f32 engine pair (clocks and rids in their output numbered or
masked). Exit codes and printed output must be
equal, with random Task names numbered in order of first appearance; the
phase lines that ``--follow`` prints while it polls depend on timing, so
only its last is compared, and ``-o yaml`` is compared as the documents it
parses to (the port writes YAML with its own ``yamlsubset.dump_all``; both
texts must load in ``yaml.safe_load_all``).
"""

import dataclasses
import io
import re
import sys

import numpy as np
import pytest
import yaml

from agentcontrolplane_tpu.cli import main as ref_main
from agentcontrolplane_tpu_torch.cli import main as port_main

from .test_torch_rest import GETTING_STARTED, Live, normalized

MAINS = {"ref": ref_main, "port": port_main}


class Cli:
    def __init__(self, pkg, h, capsys, token=None):
        self.main, self.h, self.capsys = MAINS[pkg], h, capsys
        self.prefix = ["--server", h.base] + (["--token", token] if token else [])

    def __call__(self, *argv):
        self.capsys.readouterr()
        rc = self.main(self.prefix + list(argv))
        out, err = self.capsys.readouterr()
        return rc, out, err


def _follow_view(out: str) -> str:
    """``task create --follow``'s output with only its last phase line."""
    lines = out.splitlines()
    phases = [i for i, ln in enumerate(lines) if ln.startswith("  phase: ")]
    keep = set(phases[-1:])
    return "\n".join(ln for i, ln in enumerate(lines) if i not in phases or i in keep)


def _flow(pkg, capsys, tmp_path):
    manifest = tmp_path / "m.yaml"
    manifest.write_text(GETTING_STARTED)
    with Live(pkg) as h:
        h.mock.default = h.ns.assistant("Paris")
        cli = Cli(pkg, h, capsys)
        out = [cli("apply", "-f", str(manifest))]
        h.wait(lambda: h.call("GET", "/v1/agents/my-assistant")[1]["ready"]
               and h.call("GET", "/v1/tasks/hello-world-1")[1]["phase"] == "FinalAnswer",
               "the applied Agent Ready and its Task done")
        h.freeze("agent", "llm")
        out += [cli("get", "Agent"), cli("get", "LLM"), cli("get", "Bogus")]
        rc, text, err = cli("get", "LLM", "gpt-4o", "-o", "yaml")
        out.append((rc, list(yaml.safe_load_all(text)), err))
        rc, text, err = cli("get", "Task", "-o", "yaml")
        out.append((rc, list(yaml.safe_load_all(text)), err))
        rc, text, err = cli("task", "create", "my-assistant", "hi", "--follow")
        out.append((rc, _follow_view(text), err))
        name = re.search(r"task/(\S+) created", text).group(1)
        out += [cli("events"), cli("task", "show", name), cli("task", "show", "hello-world-1"),
                cli("task", "show", "ghost"), cli("task", "create", "ghost", "hi"), cli("engine"),
                cli("delete", "Task", "hello-world-1"), cli("delete", "Task", "hello-world-1"),
                cli("get", "Task")]
    assert [o[0] for o in out] == [0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0]
    return out


def test_live_server_flow_matches_the_reference(capsys, tmp_path):
    views = {pkg: _flow(pkg, capsys, tmp_path) for pkg in ("ref", "port")}
    assert normalized(views["port"]) == normalized(views["ref"])


def _human(pkg, capsys):
    with Live(pkg) as h:
        client = h.op.hl_factory.create_client("")
        spec = h.ns.HL.FunctionCallSpec(fn="echo__echo", kwargs={"text": "hi"})
        h.sync(client.request_approval("run1", "call-abc", spec))
        h.sync(client.request_approval("run2", "call-def", spec))
        h.sync(client.request_human_contact("run3", "call-h", "which region?"))
        cli = Cli(pkg, h, capsys)
        out = [cli("approvals"), cli("approvals", "list"),
               cli("approvals", "approve", "call-abc", "--comment", "ok"),
               cli("approvals", "reject", "call-def"), cli("approvals", "reject", "call-zzz"),
               cli("approvals", "approve"), cli("approvals"),
               cli("contacts"), cli("contacts", "respond", "call-h"),
               cli("contacts", "respond", "call-zzz", "x"),
               cli("contacts", "respond", "call-h", "eu-west"), cli("contacts"),
               cli("contacts", "list")]
        assert h.sync(client.get_function_call_status("call-abc")).approved is True
        assert h.sync(client.get_human_contact_status("call-h")).response == "eu-west"
    assert [o[0] for o in out] == [0, 0, 0, 0, 1, 2, 0, 0, 2, 1, 0, 0, 0]
    return out


def test_approvals_and_contacts_match_the_reference(capsys):
    assert _human("port", capsys) == _human("ref", capsys)


def _token(pkg, capsys):
    with Live(pkg, api_token="s3cret") as h:
        out = [Cli(pkg, h, capsys)("get", "Agent"), Cli(pkg, h, capsys, "s3cret")("get", "Agent"),
               Cli(pkg, h, capsys, "wrong")("engine")]
    assert [o[0] for o in out] == [1, 0, 1]
    return out


def test_bearer_token_matches_the_reference(capsys, monkeypatch):
    monkeypatch.delenv("ACP_API_TOKEN", raising=False)
    assert _token("port", capsys) == _token("ref", capsys)


def test_chat_matches_the_reference(capsys, monkeypatch):
    """``chat`` streams from the operator's chat route: the greedy reply
    printed is the same text; without an engine both print the 503."""
    import jax

    from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
    from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
    from agentcontrolplane_tpu.models import llama as jl
    from agentcontrolplane_tpu.parallel.mesh import make_mesh
    from agentcontrolplane_tpu_torch.engine.engine import Engine
    from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
    from agentcontrolplane_tpu_torch.models import llama as tl

    jcfg = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
    tcfg = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
    kw = dict(max_slots=2, max_ctx=256, prefill_buckets=(128, 256), decode_block_size=4,
              page_size=8)
    p = jax.tree_util.tree_map(np.array, jl.init_params(jcfg, jax.random.key(1)))
    engines = {
        "ref": JaxEngine(config=jcfg, params=jax.tree_util.tree_map(jax.numpy.asarray, p),
                         tokenizer=JaxByteTokenizer(),
                         mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
                         kv_layout="paged", prefix_cache_entries=0, **kw),
        "port": Engine(tcfg, params_from_jax(p, tcfg, device="cpu"), device="cpu", **kw),
    }
    argv = ("chat", "--system", "be brief", "--max-tokens", "10", "--temperature", "0")
    views = {}
    try:
        for pkg, engine in engines.items():
            engine.start()
            with Live(pkg, engine=engine) as h:
                monkeypatch.setattr(sys, "stdin", io.StringIO("hello\nagain\n\n"))
                served = Cli(pkg, h, capsys)(*argv)
            with Live(pkg) as h:
                monkeypatch.setattr(sys, "stdin", io.StringIO("hello\n"))
                views[pkg] = [served, Cli(pkg, h, capsys)(*argv)]
    finally:
        for engine in engines.values():
            engine.stop()
    assert views["port"] == views["ref"]
    (rc, out, err), (rc_none, _, err_none) = views["port"]
    assert rc == 0 and not err and out.count("> ") == 3
    assert rc_none == 0 and "error:" in err_none and "no TPU engine configured" in err_none


@pytest.mark.parametrize("argv,rc", [
    (["run", "--help"], 0),
    (["task", "create", "--help"], 0),
    (["get", "Agent", "-o", "json"], 2),
    (["perf", "--help"], 0),
    (["timeline", "--help"], 0),
    (["trace", "export", "--help"], 0),
    (["trace"], 2),
])
def test_parser_matches_the_reference(argv, rc, capsys):
    """The flags the two CLIs share parse alike (both exit through
    argparse here)."""
    codes = []
    for main in (ref_main, port_main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        codes.append(e.value.code)
        capsys.readouterr()
    assert codes == [rc, rc]


def test_run_serves_the_operator_until_signalled(tmp_path, monkeypatch):
    """``run`` builds the options from its flags, serves the REST API on
    the bound port and stops everything once signalled."""
    import agentcontrolplane_tpu_torch.operator as port_operator

    seen = {}

    async def signalled():
        import urllib.request

        op_port = seen["port"] = int(seen["printed"].rsplit(":", 1)[1])
        with urllib.request.urlopen(f"http://127.0.0.1:{op_port}/readyz", timeout=10) as r:
            seen["readyz"] = r.status

    real_print = print

    def capture(*a, **kw):
        if a and str(a[0]).startswith("operator running; REST API on :"):
            seen["printed"] = str(a[0])
        real_print(*a, **kw)

    monkeypatch.setattr(port_operator, "serve_until_signalled", signalled)
    monkeypatch.setattr("builtins.print", capture)
    assert port_main(["run", "--db", str(tmp_path / "acp.db"), "--port", "0",
                      "--api-token", "t"]) == 0
    assert seen["readyz"] == 200 and seen["port"] > 0
    assert (tmp_path / "acp.db").exists()


def test_run_with_a_preset_needs_the_card_unless_told_cpu(monkeypatch):
    """``run --tpu-preset`` builds its engine on CUDA by default: without a
    card it raises before serving anything."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        port_main(["run", "--tpu-preset", "tiny", "--port", "0"])


def test_run_host_kv_flags_parse_and_reach_the_engine(tmp_path, monkeypatch):
    """``run --tpu-host-kv-bytes/--tpu-host-prefetch`` carry the reference's
    defaults and help, parse, and reach ``Engine`` as the reference's
    ``_build_engine`` passes them."""
    import argparse

    import agentcontrolplane_tpu_torch.operator as port_operator
    from agentcontrolplane_tpu.cli import build_parser as ref_parser
    from agentcontrolplane_tpu_torch import cli as port_cli
    from agentcontrolplane_tpu_torch.engine import engine as port_engine_mod

    flags = ("tpu_host_kv_bytes", "tpu_host_prefetch")

    def run_flags(parser) -> dict:
        run = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction)).choices["run"]
        return {a.dest: (a.default, a.help) for a in run._actions if a.dest in flags}

    ours = run_flags(port_cli.build_parser())
    assert len(ours) == len(flags) and ours == run_flags(ref_parser())
    built = {}

    class FakeEngine:
        def __init__(self, *args, **kw):
            built.update(kw)

        def start(self):
            pass

        def stop(self):
            pass

    async def no_serve():
        return None

    monkeypatch.setattr(port_engine_mod, "Engine", FakeEngine)
    monkeypatch.setattr(port_operator, "serve_until_signalled", no_serve)
    base = ["run", "--db", str(tmp_path / "acp.db"), "--tpu-preset", "tiny", "--device", "cpu",
            "--port", "0"]
    port_cli.cmd_run(port_cli.build_parser().parse_args(base))
    assert (built["host_kv_bytes"], built["host_prefetch"]) == (0, True)
    port_cli.cmd_run(port_cli.build_parser().parse_args(
        base + ["--tpu-host-kv-bytes", str(1 << 30), "--tpu-host-prefetch", "0"]))
    assert (built["host_kv_bytes"], built["host_prefetch"]) == (1 << 30, False)


_CLOCK = re.compile(r"\d+\.\d+(?:e-?\d+)?")
_RID = re.compile(r"\b[0-9a-f]{8}\b")


def _masked(text: str) -> str:
    """Output with clock readings masked (and the padding their widths
    change), rids numbered in order."""
    seen: dict = {}
    text = re.sub(r" +", " ", _CLOCK.sub("<t>", text))
    return _RID.sub(lambda m: "<rid %d>" % seen.setdefault(m.group(0), len(seen)), text)


def test_perf_timeline_trace_match_the_reference(capsys, tmp_path):
    """After one chat request: ``perf`` (its ledger and program rows),
    ``timeline`` (the window, then the request's events and phases) and
    ``trace export -o`` print the reference's lines, clocks masked; an
    unknown rid fails alike."""
    import json as _json

    from .test_torch_rest import _engine_pair

    body = {"model": "tiny", "max_tokens": 8, "temperature": 0,
            "messages": [{"role": "user", "content": "observe me"}]}
    views = {}
    engines = _engine_pair()
    try:
        for pkg, engine in engines.items():
            engine.start()
            with Live(pkg, engine=engine) as h:
                assert h.call("POST", "/v1/chat/completions", body)[0] == 200
                cli = Cli(pkg, h, capsys)
                rid = h.call("GET", "/v1/engine/flight")[1]["request_ids"][-1]
                perf = cli("perf")
                perf_json = _json.loads(cli("perf", "--json")[1])
                (tmp_path / pkg).mkdir()
                out_file = tmp_path / pkg / "trace.json"
                trace = cli("trace", "export", "-o", str(out_file))
                doc = _json.loads(out_file.read_text())
                views[pkg] = {
                    # program rows are sorted by host time: compared as a set
                    "perf": (perf[0], sorted(ln.split()[0] for ln in perf[1].splitlines()),
                             perf[2]),
                    "perf_json": ({k: v["dispatches"] for k, v in perf_json["programs"].items()},
                                  perf_json["goodput"]),
                    "window": [_masked(x) if isinstance(x, str) else x
                               for x in cli("timeline", "--last", "5")],
                    "timeline": [_masked(x) if isinstance(x, str) else x
                                 for x in cli("timeline", rid)],
                    "ghost": cli("timeline", "nope")[0],
                    "trace": (trace[0], _masked(trace[1].replace(str(tmp_path / pkg), "<dir>")),
                              [{k: v for k, v in r.items() if k != "offset_s"}
                               for r in doc["requests"]]),
                }
    finally:
        for engine in engines.values():
            engine.stop()
    assert views["port"] == views["ref"]
    port = views["port"]
    assert port["perf"][0] == 0 and "goodput:" in port["perf"][1]
    assert port["timeline"][0] == 0 and "phases" in port["timeline"][1]
    assert port["ghost"] == 1 and port["trace"][0] == 0 and port["trace"][2]


def test_run_autopilot_flag_parses_and_reaches_the_engine(tmp_path, monkeypatch):
    """``run --tpu-autopilot`` carries the reference's default and help and
    reaches ``Engine(autopilot=)``."""
    import argparse

    import agentcontrolplane_tpu_torch.operator as port_operator
    from agentcontrolplane_tpu.cli import build_parser as ref_parser
    from agentcontrolplane_tpu_torch import cli as port_cli
    from agentcontrolplane_tpu_torch.engine import engine as port_engine_mod

    def run_flag(parser):
        run = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction)).choices["run"]
        return [(a.default, a.help) for a in run._actions if a.dest == "tpu_autopilot"]

    assert run_flag(port_cli.build_parser()) == run_flag(ref_parser()) != []
    built = {}

    class FakeEngine:
        def __init__(self, *args, **kw):
            built.update(kw)

        def start(self):
            pass

        def stop(self):
            pass

    async def no_serve():
        return None

    monkeypatch.setattr(port_engine_mod, "Engine", FakeEngine)
    monkeypatch.setattr(port_operator, "serve_until_signalled", no_serve)
    base = ["run", "--db", str(tmp_path / "acp.db"), "--tpu-preset", "tiny", "--device", "cpu",
            "--port", "0"]
    port_cli.cmd_run(port_cli.build_parser().parse_args(base))
    assert built["autopilot"] is False
    port_cli.cmd_run(port_cli.build_parser().parse_args(base + ["--tpu-autopilot", "1"]))
    assert built["autopilot"] is True


def test_run_kv_layout_flag_parses_and_reaches_the_engine(tmp_path, monkeypatch):
    """``run --tpu-kv-layout`` carries the reference's choices, default
    (``slot``) and help, and reaches ``Engine(kv_layout=)``."""
    import argparse

    import agentcontrolplane_tpu_torch.operator as port_operator
    from agentcontrolplane_tpu.cli import build_parser as ref_parser
    from agentcontrolplane_tpu_torch import cli as port_cli
    from agentcontrolplane_tpu_torch.engine import engine as port_engine_mod

    def run_flag(parser):
        run = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction)).choices["run"]
        return [(a.default, a.help, a.choices) for a in run._actions
                if a.dest == "tpu_kv_layout"]

    assert run_flag(port_cli.build_parser()) == run_flag(ref_parser()) != []
    assert run_flag(port_cli.build_parser())[0][0] == "slot"
    built = {}

    class FakeEngine:
        def __init__(self, *args, **kw):
            built.update(kw)

        def start(self):
            pass

        def stop(self):
            pass

    async def no_serve():
        return None

    monkeypatch.setattr(port_engine_mod, "Engine", FakeEngine)
    monkeypatch.setattr(port_operator, "serve_until_signalled", no_serve)
    base = ["run", "--db", str(tmp_path / "acp.db"), "--tpu-preset", "tiny", "--device", "cpu",
            "--port", "0"]
    port_cli.cmd_run(port_cli.build_parser().parse_args(base))
    assert built["kv_layout"] == "slot"
    port_cli.cmd_run(port_cli.build_parser().parse_args(base + ["--tpu-kv-layout", "paged"]))
    assert built["kv_layout"] == "paged"
