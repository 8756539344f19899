"""The port's leases, work queue and controller manager against the JAX
package's, on the CPU.

- ``try_acquire_epoch``/``try_acquire``/``holder``/``release`` with
  injected times: the same epochs, holders and lease documents, adoption
  after the TTL included; ``LeaseHeartbeat`` renews, reports a lease
  another holder adopted, and releases on ``remove``.
- ``WorkQueue`` under one scripted sequence of adds, delayed adds, re-adds
  while active, rate-limited adds and shutdown, with the queue's clock
  injected: the same hand-out order and lengths.
- Two ``Manager``s (two identities) with leader election and a toy
  reconciler writing through ``fenced_store()`` contend for the same
  objects: exactly one identity wins every object, in both packages.
"""

import asyncio
import json
import time
import types

import pytest

import agentcontrolplane_tpu.api.resources as ref_resources
import agentcontrolplane_tpu.kernel as ref_kernel
import agentcontrolplane_tpu.kernel.lease as ref_lease
import agentcontrolplane_tpu.kernel.queue as ref_queue
import agentcontrolplane_tpu_torch.api.resources as port_resources
import agentcontrolplane_tpu_torch.kernel as port_kernel
import agentcontrolplane_tpu_torch.kernel.lease as port_lease
import agentcontrolplane_tpu_torch.kernel.queue as port_queue

REF = types.SimpleNamespace(R=ref_resources, K=ref_kernel, lease=ref_lease, queue=ref_queue)
PORT = types.SimpleNamespace(R=port_resources, K=port_kernel, lease=port_lease, queue=port_queue)
BOTH = pytest.mark.parametrize("ns", [REF, PORT], ids=["reference", "port"])


def _lease_doc(store, name="l"):
    doc = json.loads(json.dumps(store.get("Lease", name).model_dump()))
    doc["metadata"]["uid"] = doc["metadata"]["creation_timestamp"] = None
    return doc


def _lease_trace(ns) -> list:
    store, L = ns.K.Store(), ns.lease
    out = [
        L.try_acquire_epoch(store, "l", "A", ttl=10.0, now=100.0),  # create -> 1
        L.try_acquire_epoch(store, "l", "A", ttl=10.0, now=105.0),  # renew keeps 1
        L.try_acquire_epoch(store, "l", "B", ttl=10.0, now=108.0),  # live: refused
        L.try_acquire(store, "l", "B", ttl=10.0, now=114.0),  # renewed at 105: live
        L.holder(store, "l", now=110.0),
        L.holder(store, "l", now=116.0),  # expired: nobody
        _lease_doc(store),
        L.try_acquire_epoch(store, "l", "B", ttl=5.0, now=116.0),  # adopt -> 2
        _lease_doc(store),
        L.try_acquire_epoch(store, "l", "A", ttl=10.0, now=118.0),  # refused
    ]
    L.release(store, "l", "A")  # not the holder: no change
    out.append(_lease_doc(store))
    L.release(store, "l", "B")
    out += [_lease_doc(store), L.holder(store, "l", now=118.5),
            L.try_acquire_epoch(store, "l", "A", ttl=10.0, now=119.0),  # epochs stay monotonic
            L.holder(store, "missing", now=119.0)]
    L.release(store, "missing", "A")
    return out


def test_lease_semantics_match_the_reference():
    ours, ref = _lease_trace(PORT), _lease_trace(REF)
    assert ours == ref
    assert [ours[i] for i in (0, 1, 2, 3, 7, 9, 13)] == [1, 1, None, False, 2, None, 3]
    assert ours[11]["spec"]["holder_identity"] == "" and ours[11]["spec"]["epoch"] == 2
    assert ours[12] is None and ours[14] is None


@BOTH
def test_lease_heartbeat_renews_reports_and_releases(ns):
    store, lost = ns.K.Store(), []
    hb = ns.lease.LeaseHeartbeat(store, interval=60.0, ttl=30.0, on_lost=lost.append)
    assert hb.add("r0", "pod-a") == 1
    assert hb.add("r1", "pod-a") == 1
    assert ns.lease.LeaseHeartbeat(store).add("r0", "pod-b") is None  # live elsewhere
    # another holder adopts r1 (as after expiry): the next beat reports it
    ns.lease.try_acquire_epoch(store, "r1", "pod-b", ttl=30.0, now=time.time() + 120.0)
    hb.beat()
    assert lost == ["r1"] and hb.epochs == {"r0": 1}
    hb.remove("r0")
    assert ns.lease.holder(store, "r0") is None
    assert store.get("Lease", "r0").spec.epoch == 1


class FakeTime:
    """The queue module's ``time``: a clock the test advances."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


QUEUE_SCRIPT = [
    ("add", "a"), ("add", "a"), ("add", "b"), ("after", "c", 2.0), ("after", "a", 1.0),
    ("len",), ("get",), ("add", "a"), ("get",), ("tick", 1.5), ("len",), ("done", "b"),
    ("done", "a"), ("get",), ("after", "b", 0.0), ("get",), ("tick", 1.0), ("get",),
    ("rate", "d"), ("rate", "d"), ("len",), ("tick", 0.006), ("get",), ("done", "d"),
    ("rate", "d"), ("tick", 0.006), ("len",), ("tick", 0.006), ("get",), ("forget", "d"),
    ("done", "d"), ("rate", "d"), ("tick", 0.006), ("get",), ("done", "c"), ("add", "e"),
    ("shutdown",), ("add", "f"), ("get",), ("get",),
]


async def _queue_trace(ns, monkeypatch) -> list:
    clock = FakeTime()
    monkeypatch.setattr(ns.queue, "time", clock)
    q, out = ns.K.WorkQueue(), []
    for op, *args in QUEUE_SCRIPT:
        if op == "add":
            q.add(args[0])
        elif op == "after":
            q.add_after(args[0], args[1])
        elif op == "rate":
            q.add_rate_limited(args[0])
        elif op == "tick":
            clock.now += args[0]
        elif op == "len":
            out.append(("len", len(q)))
        elif op == "get":
            out.append(("get", await asyncio.wait_for(q.get(), 1.0)))
        else:
            getattr(q, op)(*args)
    return out


async def test_work_queue_order_matches_the_reference(monkeypatch):
    ours = await _queue_trace(PORT, monkeypatch)
    ref = await _queue_trace(REF, monkeypatch)
    assert ours == ref
    gets = [v for k, v in ours if k == "get"]
    assert gets == ["a", "b", "a", "b", "c", "d", "d", "d", "e", None]


class ClaimReconciler:
    """Claims each Task for its manager's identity, writing through the
    fenced store; a fencing refusal is retried shortly."""

    def __init__(self, ns, manager):
        self.ns, self.identity = ns, manager.identity
        self.store = manager.fenced_store()
        self.refused = 0

    async def reconcile(self, key):
        _, ns_, name = key

        def claim(obj):
            if not obj.status.status_detail:
                obj.status.status_detail = f"claimed by {self.identity}"

        try:
            self.store.mutate_status("Task", name, ns_, claim)
        except self.ns.K.Conflict:
            self.refused += 1
            return self.ns.K.Result.after(0.02)
        return self.ns.K.Result.done()


@BOTH
async def test_two_managers_give_exactly_one_winner(ns):
    store = ns.K.Store()
    managers = [ns.K.Manager(store, identity=i, leader_election=True) for i in ("m-a", "m-b")]
    recs = [ClaimReconciler(ns, m) for m in managers]
    for m, r in zip(managers, recs):
        m.add_controller("task", "Task", r, workers=2)
    names = [f"t{i}" for i in range(4)]
    for n in names:
        store.create(ns.R.Task.model_validate({
            "metadata": {"name": n}, "spec": {"agentRef": {"name": "a"}, "userMessage": "m"}}))
    for m in managers:
        await m.start()
    try:
        def claimed():
            return all(store.get("Task", n).status.status_detail for n in names)

        await managers[0].run_until(claimed, timeout=10)
        winners = {store.get("Task", n).status.status_detail for n in names}
        leaders = [m.identity for m in managers if m.elector.is_leader]
        assert len(leaders) == 1
        assert winners == {f"claimed by {leaders[0]}"}
        loser = next(r for r, m in zip(recs, managers) if m.identity != leaders[0])
        assert loser.refused >= 1
        assert ns.lease.holder(store, "acp-tpu-leader") == leaders[0]
    finally:
        for m in managers:
            await m.stop()
    assert ns.lease.holder(store, "acp-tpu-leader") is None  # released at stop


class _FlakyReconciler:
    """Fails its first reconcile of each key, then succeeds."""

    def __init__(self, ns):
        self.ns, self.seen = ns, set()

    async def reconcile(self, key):
        if key not in self.seen:
            self.seen.add(key)
            raise RuntimeError("first reconcile fails")
        return self.ns.K.Result.done()


async def test_manager_counts_reconciles_like_the_reference():
    """``acp_reconcile_total{controller,result}`` and the
    ``acp_reconcile_duration_seconds`` observations: the same counts on
    both managers for the same reconciles."""
    from agentcontrolplane_tpu.observability.metrics import REGISTRY as ref_registry
    from agentcontrolplane_tpu_torch.observability.metrics import REGISTRY as port_registry

    def counts(reg):
        m = reg._metrics.get("acp_reconcile_total")
        vals = {} if m is None else m.values
        h = reg.series_window("acp_reconcile_duration_seconds", {"controller": "flaky"})[0]
        return (vals.get((("controller", "flaky"), ("result", "error")), 0.0),
                vals.get((("controller", "flaky"), ("result", "success")), 0.0), h)

    deltas = []
    for ns, reg in ((REF, ref_registry), (PORT, port_registry)):
        store = ns.K.Store()
        mgr = ns.K.Manager(store, identity="m")
        rec = _FlakyReconciler(ns)
        mgr.add_controller("flaky", "Task", rec)
        c0 = counts(reg)
        for n in ("t0", "t1"):
            store.create(ns.R.Task.model_validate({
                "metadata": {"name": n}, "spec": {"agentRef": {"name": "a"}, "userMessage": "m"}}))
        await mgr.start()
        try:
            c1 = c0
            deadline = time.monotonic() + 10
            while c1[1] - c0[1] < 2:
                assert time.monotonic() < deadline
                await asyncio.sleep(0.02)
                c1 = counts(reg)
        finally:
            await mgr.stop()
        deltas.append(tuple(b - a for a, b in zip(c0, counts(reg))))
    assert deltas[1] == deltas[0] == (2.0, 2.0, 2)
