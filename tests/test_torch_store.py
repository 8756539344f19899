"""The port's store against the JAX package's, on the CPU.

One scripted sequence of 44 operations is replayed on both stores, over
both backends (in memory, sqlite): create, ``AlreadyExists``, a stale-RV
``Conflict``, update and update_status (generation tracking), invalid
state, ``mutate_status``, label-selector and cross-namespace lists, a
precondition delete, a delete whose owner-reference GC cascades two
levels, fences that are good, stale, held by another holder, for a missing
lease or expired, ``FencedStore``, and lease release. Every step must give
the same documents, resource versions, exception types and messages, and
the watch must see the same event sequence. A sqlite file written by
either store opens in the other with the same objects and counter.
"""

import json
import time
import types

import pytest

import agentcontrolplane_tpu.api.resources as ref_resources
import agentcontrolplane_tpu.kernel as ref_kernel
import agentcontrolplane_tpu.kernel.lease as ref_lease
import agentcontrolplane_tpu_torch.api.resources as port_resources
import agentcontrolplane_tpu_torch.kernel as port_kernel
import agentcontrolplane_tpu_torch.kernel.lease as port_lease

REF = types.SimpleNamespace(R=ref_resources, K=ref_kernel, lease=ref_lease)
PORT = types.SimpleNamespace(R=port_resources, K=port_kernel, lease=port_lease)
T0 = 1_800_000_000.0
LEASE = "leader"


class Clock:
    """``time.time`` for the store's fence expiry check."""

    def __init__(self):
        self.now = T0

    def __call__(self):
        return self.now


def _obj(ns, kind, name, spec=None, labels=None, owners=(), namespace="default", at=0.0):
    """An object with a pinned uid and creation time, built from a mapping
    so one helper serves both packages."""
    meta = {"name": name, "namespace": namespace, "uid": f"uid-{kind}-{namespace}-{name}",
            "labels": dict(labels or {}), "creationTimestamp": T0 + at,
            "ownerReferences": [{"kind": k, "name": n, "uid": f"uid-{k}-{namespace}-{n}"}
                                for k, n in owners]}
    return ns.R.KINDS[kind].model_validate({"kind": kind, "metadata": meta, "spec": spec or {}})


LLM_SPEC = {"provider": "tpu", "tpu": {"preset": "tiny"}, "parameters": {"model": "m"}}
AGENT_SPEC = {"llmRef": {"name": "l1"}, "system": "be brief"}
TASK_SPEC = {"agentRef": {"name": "a1"}, "userMessage": "hi"}
TC_SPEC = {"toolCallId": "c0", "taskRef": {"name": "t1"}, "toolRef": {"name": "fetch__get"},
           "toolType": "MCP"}


def _lease_obj(ns, holder, epoch, ttl=10.0):
    lease = _obj(ns, "Lease", LEASE, {"holderIdentity": holder, "leaseDurationSeconds": ttl,
                                      "acquireTime": T0, "renewTime": T0, "epoch": epoch})
    return lease


def _fence(holder, epoch, name=LEASE):
    return {"name": name, "namespace": "default", "holder": holder, "epoch": epoch}


def script(ns, store, clock):
    """(label, thunk) steps; a thunk returns what the step observes."""
    S, K = store, ns.K
    saved = {}

    def keep(key, value):
        saved[key] = value
        return value

    def set_status(kind, name, **fields):
        def step():
            obj = S.get(kind, name)
            for k, v in fields.items():
                setattr(obj.status, k, v)
            return S.update_status(obj)
        return step

    def update(kind, name, fn):
        def step():
            obj = S.get(kind, name)
            fn(obj)
            return S.update(obj)
        return step

    def fenced(fence_fn):
        return K.FencedStore(S, fence_fn)

    def set_model(o):
        o.spec.parameters.model = "m2"

    def set_label(o):
        o.metadata.labels["tier"] = "gold"

    def set_bogus(o):
        o.status.status = "Bogus"

    def pending(o):
        o.status.status = "Pending"
        o.status.status_detail = "waiting"

    def status_with_spec_change():
        """The status subresource keeps the stored spec."""
        obj = S.get("LLM", "l1")
        obj.spec.parameters.model = "m3"
        obj.status.status_detail = "spec moved too"
        return S.update_status(obj)

    return [
        ("create secret", lambda: S.create(_obj(ns, "Secret", "s1", {"data": {"k": "v"}}))),
        ("create secret again", lambda: S.create(_obj(ns, "Secret", "s1"))),
        ("create llm", lambda: keep("l1", S.create(_obj(ns, "LLM", "l1", LLM_SPEC,
                                                        {"tier": "a"}, at=1)))),
        ("create agent a1", lambda: S.create(_obj(ns, "Agent", "a1", AGENT_SPEC, {"tier": "a"},
                                                  at=2))),
        ("create agent a2", lambda: S.create(_obj(ns, "Agent", "a2", AGENT_SPEC, {"tier": "b"},
                                                  at=3))),
        ("create agent other ns", lambda: S.create(_obj(ns, "Agent", "a1", AGENT_SPEC,
                                                        namespace="other", at=4))),
        ("create nameless", lambda: S.create(_obj(ns, "Agent", "", AGENT_SPEC))),
        ("get llm", lambda: S.get("LLM", "l1")),
        ("get missing", lambda: S.get("LLM", "nope")),
        ("try_get missing", lambda: S.try_get("LLM", "nope")),
        ("status ready", set_status("LLM", "l1", ready=True, status="Ready")),
        ("stale update", lambda: S.update(saved["l1"])),
        ("stale status", lambda: S.update_status(saved["l1"])),
        ("spec change", update("LLM", "l1", set_model)),
        ("labels only", update("LLM", "l1", set_label)),
        ("spec via status", status_with_spec_change),
        ("invalid state", update("LLM", "l1", set_bogus)),
        ("get after invalid", lambda: S.get("LLM", "l1")),
        ("mutate_status", lambda: S.mutate_status("Agent", "a1", "default", pending)),
        ("mutate missing", lambda: S.mutate_status("Agent", "zz", "default", pending)),
        ("list tier=a", lambda: S.list("Agent", label_selector={"tier": "a"})),
        ("list all ns", lambda: S.list("Agent", namespace=None)),
        ("list other ns", lambda: S.list("LLM", namespace="other")),
        ("create task", lambda: S.create(_obj(ns, "Task", "t1", TASK_SPEC,
                                              owners=[("Agent", "a1")], at=5))),
        ("create tc1", lambda: S.create(_obj(ns, "ToolCall", "tc1", TC_SPEC,
                                             owners=[("Task", "t1")], at=6))),
        ("create tc2", lambda: S.create(_obj(ns, "ToolCall", "tc2", TC_SPEC,
                                             owners=[("Task", "t1")], at=7))),
        ("delete stale rv", lambda: S.delete("Agent", "a1", resource_version=1)),
        ("delete cascades", lambda: S.delete("Agent", "a1")),
        ("tasks after gc", lambda: S.list("Task", namespace=None)),
        ("toolcalls after gc", lambda: S.list("ToolCall", namespace=None)),
        ("delete missing", lambda: S.delete("Agent", "a1")),
        ("create lease", lambda: S.create(_lease_obj(ns, "A", 1))),
        ("fenced create", lambda: S.create(_obj(ns, "Secret", "s2"), fence=_fence("A", 1))),
        ("wrong holder", lambda: S.create(_obj(ns, "Secret", "s3"), fence=_fence("B", 1))),
        ("stale epoch", lambda: S.create(_obj(ns, "Secret", "s3"), fence=_fence("A", 2))),
        ("missing lease", lambda: S.create(_obj(ns, "Secret", "s3"), fence=_fence("A", 1, "x"))),
        ("fence expired", lambda: (setattr(clock, "now", T0 + 11.0),
                                   S.create(_obj(ns, "Secret", "s3"),
                                            fence=_fence("A", 1)))[-1]),
        ("adopt", lambda: ns.lease.try_acquire_epoch(S, LEASE, "B", ttl=10.0, now=T0 + 11.0)),
        ("fenced store ok", lambda: fenced(lambda: _fence("B", 2)).mutate_status(
            "Agent", "a2", "default", pending)),
        ("not leader", lambda: fenced(lambda: None).delete("Agent", "a2")),
        ("deposed mutate", lambda: fenced(lambda: _fence("A", 1)).mutate_status(
            "Agent", "a2", "default", pending)),
        ("release by non-holder", lambda: (ns.lease.release(S, LEASE, "A"),
                                           S.get("Lease", LEASE))[-1]),
        ("release", lambda: (ns.lease.release(S, LEASE, "B"), S.get("Lease", LEASE))[-1]),
        ("precondition delete", lambda: S.delete("Agent", "a2",
                                                 resource_version=S.get("Agent", "a2")
                                                 .metadata.resource_version)),
    ]


def _view(value):
    """What a step observed, in a form both packages share."""
    if isinstance(value, list):
        return [_view(v) for v in value]
    if hasattr(value, "model_dump"):
        return json.loads(json.dumps(value.model_dump()))
    return value


def _error(e: Exception) -> tuple:
    msg = str(e)
    if msg.startswith("invalid object state"):  # the tail is the validator's text
        msg = msg.split(":")[0]
    return ("raised", type(e).__name__, msg)


async def _replay(ns, store, monkeypatch) -> tuple[list, list]:
    clock = Clock()
    monkeypatch.setattr(time, "time", clock)
    watch = store.watch(["LLM", "Agent", "Task", "ToolCall", "Lease", "Secret"])
    out = []
    for label, step in script(ns, store, clock):
        try:
            out.append((label, _view(step())))
        except Exception as e:  # noqa: BLE001 - the exception is the observation
            out.append((label, _error(e)))
    events = []
    while (ev := await watch.next(timeout=0.01)) is not None:
        events.append((ev.type, ev.object.kind, ev.object.metadata.namespace,
                       ev.object.metadata.name, ev.object.metadata.resource_version))
    watch.stop()
    return out, events


def _store(ns, backend, path):
    if backend == "memory":
        return ns.K.Store()
    return ns.K.Store(ns.K.SqliteBackend(str(path)))


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
async def test_scripted_sequence_matches_the_reference(backend, tmp_path, monkeypatch):
    ref_store = _store(REF, backend, tmp_path / "ref.db")
    port_store = _store(PORT, backend, tmp_path / "port.db")
    ref_out, ref_events = await _replay(REF, ref_store, monkeypatch)
    port_out, port_events = await _replay(PORT, port_store, monkeypatch)
    assert len(port_out) == len(ref_out) == 44
    for (label, want), (_, got) in zip(ref_out, port_out):
        assert got == want, label
    assert port_events == ref_events
    kinds = [e[0] for e in port_events]
    assert {"ADDED", "MODIFIED", "DELETED"} <= set(kinds)
    # the cascade and the fence outcomes the script is built around
    assert dict(port_out)["toolcalls after gc"] == []
    assert dict(port_out)["fence expired"][1] == "Conflict"
    assert dict(port_out)["adopt"] == 2
    assert port_store._rv == ref_store._rv
    ref_store.close()
    port_store.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
async def test_sqlite_files_open_in_the_other_package(writer, tmp_path, monkeypatch):
    path = tmp_path / "store.db"
    write_ns, read_ns = (REF, PORT) if writer == "reference" else (PORT, REF)
    store = _store(write_ns, "sqlite", path)
    await _replay(write_ns, store, monkeypatch)
    written = {k: sorted(json.dumps(_view(o), sort_keys=True)
                         for o in store.list(k, namespace=None))
               for k in ("Secret", "LLM", "Agent", "Lease", "Task")}
    rv = store._rv
    store.close()
    reopened = _store(read_ns, "sqlite", path)
    read = {k: sorted(json.dumps(_view(o), sort_keys=True)
                      for o in reopened.list(k, namespace=None))
            for k in written}
    assert read == written
    assert sum(len(v) for v in read.values()) >= 5
    assert reopened._rv == rv
    # the reopened store goes on from the persisted counter
    created = reopened.create(_obj(read_ns, "Secret", "after-reopen"))
    assert created.metadata.resource_version == rv + 1
    reopened.close()
