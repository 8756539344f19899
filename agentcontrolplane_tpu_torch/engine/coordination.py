"""Lockstep serving across ranks: the admission frame stream.

The counterpart of ``agentcontrolplane_tpu/engine/coordination.py``. Every
rank of a serving group runs its own engine over its slices of the model,
and every prefill and decode step is a collective program: all ranks must
take IDENTICAL host decisions (which requests join which slots, in which
order, which are cancelled). Those decisions are deterministic functions of
the request stream, so coordination replicates that stream.

Rank 0 (the leader, behind the HTTP front door) drains its submit queue
once per engine-loop iteration and publishes one FRAME:

    {"seq": i, "reqs": [serialized requests...], "cancels": [rids...],
     "stop": false, "hold": false}

Followers receive frame i, append the same requests to their own waiting
queue (futures nobody reads: every rank computes the same tokens), apply
the same cancels, and run the same admission logic. Every decision that
reads a clock — queued-deadline expiry, the queue wait, ``max_queue``
shedding, cancels racing a finish — is taken by the leader and reaches the
followers only as a frame, so no follower decides on its own clock.

Transport: the ranks already share a process group, so frames ride
``broadcast_object_list`` on a CPU (gloo) group over all ranks
(``ServingGroup.frame_group``). The reference's TCP channel with its HELLO,
shared token and TLS is for engines on separate hosts and belongs to the
multi-host work.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import Future
from typing import Any


def serialize_request(req) -> dict[str, Any]:
    """_Request -> wire dict: the tokens and the whole sampling dict
    (``json_only`` and ``forced_prefix`` included, so every rank builds the
    same JSON table and takes the same admission decisions). Futures and the
    ``on_tokens`` / ``on_tool_call`` callbacks stay on the leader."""
    return {
        "rid": req.rid,
        "prompt": list(req.prompt),
        "sampling": dataclasses.asdict(req.sampling),
        "truncated": bool(req.truncated),
    }


def deserialize_request(doc: dict[str, Any]):
    from .engine import SamplingParams, _Request

    s = dict(doc["sampling"])
    s["forced_prefix"] = tuple(s.get("forced_prefix") or ())
    return _Request(
        rid=doc["rid"],
        prompt=list(doc["prompt"]),
        sampling=SamplingParams(**s),
        future=Future(),  # no consumer on followers
        truncated=bool(doc["truncated"]),
    )


class FrameChannel:
    """The frame stream over a serving group: :meth:`publish` on the
    leader, :meth:`recv` on followers, one frame per engine-loop iteration
    on every rank. Each call is a collective of the group's frame group."""

    def __init__(self, group):
        self.group = group
        self.seq = 0

    @property
    def leader(self) -> bool:
        return self.group.is_leader

    def publish(self, reqs, cancels, stop: bool = False, hold: bool = False) -> None:
        if not self.leader:
            raise RuntimeError("only rank 0 publishes frames")
        frame = {"seq": self.seq, "reqs": [serialize_request(r) for r in reqs],
                 "cancels": list(cancels), "stop": bool(stop), "hold": bool(hold)}
        self.group.broadcast_frame(frame)
        self.seq += 1

    def recv(self) -> dict:
        if self.leader:
            raise RuntimeError("rank 0 publishes frames; it does not receive them")
        frame = self.group.broadcast_frame(None)
        if frame["seq"] != self.seq:
            raise RuntimeError(f"frame stream out of order: got {frame['seq']}, want {self.seq}")
        self.seq += 1
        return frame
