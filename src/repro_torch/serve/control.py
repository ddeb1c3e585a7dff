"""The tick control of a meshed engine: the mesh's first rank admits, the
other ranks mirror it (``BatchedEngine(mesh=)``).

Every rank of a mesh runs the same tick bodies, so every rank must hold
the same waiting set, page tables, prefix trie and parked requests at the
start of each tick. Only the first rank takes ``submit``, ``abort`` and
``abort_all`` (the HTTP shell's calls included); at the start of each
``step()`` it broadcasts every such call since the last tick, in order,
with a stop flag, and then runs the tick. The other ranks run
``BatchedEngine.follow()``: receive a message, apply its calls in order,
run the same tick, until the stop flag. The scheduler reads no clock
outside telemetry, so nothing else can fork the ranks; each tick's
sampled ids are broadcast from the first rank as well
(``BatchedEngine._agree``).

A message goes over a gloo group of the mesh's ranks (the world group's
gloo under NCCL too): its length as one int64, then its pickled bytes
when it has any. An idle server keeps the followers from the group's
timeout (gloo's default, 30 minutes) with a heartbeat: its tick thread
runs an empty ``step()`` after ``HEARTBEAT_S`` seconds without one (an
idle tick changes no state on any rank).
"""
from __future__ import annotations

import pickle
import threading
from typing import List, Tuple

import torch
import torch.distributed as dist

HEARTBEAT_S = 5.0


class TickControl:
    """The channel from the mesh's first rank to the others, and the first
    rank's log of the calls since the last tick. Collective: every rank of
    the world builds it at the same point (it makes a process group)."""

    def __init__(self, mesh):
        ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        self.first = ranks[0]
        self.is_first = dist.get_rank() == self.first
        self.group = dist.new_group(ranks, backend="gloo")
        self._lock = threading.Lock()
        self._calls: List[tuple] = []
        self.stopped = False

    def record(self, call: tuple, req=None) -> None:
        """Log a call of the first rank for the next message: its wire form
        (picklable) and, for a submit, the request this rank queues when
        the message goes out."""
        with self._lock:
            self._calls.append((call, req))

    def pending_requests(self) -> list:
        """The requests logged for the next message."""
        with self._lock:
            return [req for _, req in self._calls if req is not None]

    def n_pending(self) -> int:
        """Submits logged since the last message."""
        with self._lock:
            return sum(req is not None for _, req in self._calls)

    def send(self, stop: bool = False) -> list:
        """First rank: broadcast the logged calls and ``stop``; returns the
        logged submits' requests, in order (the log is emptied)."""
        if self.stopped:
            raise RuntimeError("the mesh's followers were stopped: this "
                               "engine ticks no more")
        with self._lock:
            calls, self._calls = self._calls, []
        wire = [call for call, _ in calls]
        data = pickle.dumps((wire, stop)) if wire or stop else b""
        self._broadcast(data)
        self.stopped = stop
        return [req for _, req in calls if req is not None]

    def receive(self) -> Tuple[List[tuple], bool]:
        """Another rank: the next message's (calls, stop)."""
        data = self._broadcast(None)
        return pickle.loads(data) if data else ([], False)

    def _broadcast(self, data):
        n = torch.tensor([0 if data is None else len(data)], dtype=torch.int64)
        dist.broadcast(n, src=self.first, group=self.group)
        if not int(n):
            return b""
        buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8)
               if data is not None else torch.empty(int(n), dtype=torch.uint8))
        dist.broadcast(buf, src=self.first, group=self.group)
        return data if data is not None else buf.numpy().tobytes()

    def check_same(self, what: str, seq: list) -> None:
        """Raise ``RuntimeError`` naming the first entry of ``seq`` where a
        rank differs from the first rank (collective)."""
        every: list = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(every, seq, group=self.group)
        ranks = dist.get_process_group_ranks(self.group)
        want = every[0]
        for rank, got in zip(ranks, every):
            if got == want:
                continue
            i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                     min(len(got), len(want)))
            mine = got[i] if i < len(got) else "nothing"
            theirs = want[i] if i < len(want) else "nothing"
            raise RuntimeError(
                f"{what}: rank {rank} recorded {len(got)} collectives and rank "
                f"{ranks[0]} {len(want)}; the first difference is collective "
                f"{i}: {mine} on rank {rank}, {theirs} on rank {ranks[0]}")
