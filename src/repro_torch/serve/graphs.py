"""Captured tick programs: the port's counterpart of the reference engine's
ahead-of-time compiled executables (``repro/serve/engine.py`` ``warmup``
and ``self._aot``).

The engine has two fixed-shape entry points, the ``(n_slots, 1)`` decode
tick and the ``(n_slots, chunk_tokens)`` extend tick. Each is a function of
no arguments over static tensors (the params, the K/V pools, lengths and
tokens, and one device buffer per per-tick input) that writes the engine's
state in place and returns the tick's logits. A :class:`TickGraph` owns one
such function, the static buffers it reads and writes, its static output
and, on a CUDA engine, the ``torch.cuda.CUDAGraph`` s of it:

* Capture follows PyTorch's whole-network recipe: ``WARM_RUNS`` eager runs
  on a side stream (they load the kernel libraries, fill every planner's
  cache and set up cuBLAS's workspace for that stream), then one capture
  on the same stream into a memory pool that the engine's graphs share.
  Every later :meth:`TickGraph.run` replays it. A replay runs none of the
  function's Python, so the kernel wrappers' ``launches`` counters do not
  move.
* A tick under a mesh (``split=True``) holds collectives
  (``distributed/sharding.py``: ``gather_blocks``, ``sum_over``,
  ``broadcast_from_first``), which run on the host under gloo and cannot
  sit in a graph. The capture then records them (``sharding.recording``):
  each ends the current graph, which is replayed once at once so that the
  collective moves the data the tick computes, runs eagerly on tensors it
  holds, and opens the next graph in the same pool. The tick is S + 1
  graphs around S collectives, and :meth:`TickGraph.run` replays graph 0,
  runs collective 0, replays graph 1, and so on. Every rank must record
  the same collectives (``sequence``); the engine checks that. A layer
  whose attention runs on a block of the heads adds one (its output's
  ``gather_blocks`` by heads before ``wo``), so such a tick holds one
  more segment a layer, the same on every rank. The same
  split serves NCCL with a card a rank, where each collective also runs
  between the replays. Without a mesh S = 0: one graph, captured as
  ``torch.cuda.graph`` captures it.
* On a CPU engine there is no graph: :meth:`TickGraph.run` calls the
  function eagerly on the same static buffers, so the host tests exercise
  the buffer plumbing. The capture's one eager run still records the
  collectives' sequence.

The caller fills the per-tick input buffers in place (``copy_``) before
``run()``: a copy from pageable host memory cannot happen inside a
capture, and a rebound tensor would not be the one the graph reads.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.distributed.sharding import recording

# eager runs before a capture; the second finds every lazy set-up done
WARM_RUNS = 2


def describe(buffers: Dict[str, torch.Tensor]) -> str:
    """'tokens int64[3,1], ptab int32[3,6], ...' for error messages."""
    return ", ".join(
        f"{name} {str(t.dtype).removeprefix('torch.')}[{','.join(map(str, t.shape))}]"
        for name, t in buffers.items())


class _Sequence:
    """The recorder of an eager run: each collective runs where it stands,
    and its description is kept."""

    def __init__(self):
        self.ops: List[tuple] = []

    def split(self, op: tuple, run: Callable[[], None]) -> None:
        self.ops.append(op)
        run()


class _Segments(_Sequence):
    """The recorder of a split capture on the current stream: each
    collective ends the open graph, replays it, runs, and opens the next
    graph in ``pool``. The collectives' functions are kept for the
    replays."""

    def __init__(self, pool):
        super().__init__()
        self.pool = pool
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.runs: List[Callable[[], None]] = []
        self._open: Optional[torch.cuda.CUDAGraph] = None

    def begin(self) -> None:
        # a collective's device work is done before the next capture opens
        torch.cuda.current_stream().synchronize()
        self._open = torch.cuda.CUDAGraph()
        # gloo's worker threads may touch the device between segments; only
        # this thread's calls are held to the capture
        self._open.capture_begin(self.pool, capture_error_mode="thread_local")

    def end(self) -> torch.cuda.CUDAGraph:
        graph, self._open = self._open, None
        graph.capture_end()
        self.graphs.append(graph)
        return graph

    def abandon(self) -> None:
        """End an open capture after a failure (its graph is dropped)."""
        if self._open is not None:
            try:
                self._open.capture_end()
            except Exception:       # the failure being raised says more
                pass
            self._open = None

    def split(self, op: tuple, run: Callable[[], None]) -> None:
        self.ops.append(op)
        self.end().replay()
        run()
        self.runs.append(run)
        self.begin()


class TickGraph:
    """One entry point: ``fn`` over the static ``buffers`` (every tensor it
    reads or writes besides the params), its static output, and on a CUDA
    device the captured graphs (one, or S + 1 around S collectives with
    ``split``)."""

    def __init__(self, name: str, fn: Callable[[], torch.Tensor],
                 buffers: Dict[str, torch.Tensor], device: torch.device,
                 *, split: bool = False):
        self.name = name
        self.fn = fn
        self.buffers = buffers
        self.device = torch.device(device)
        self.split = split
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.collectives: List[Callable[[], None]] = []
        # (kind, mesh axis, shape, dtype) of each collective, in order
        self.sequence: List[tuple] = []
        self.output: Optional[torch.Tensor] = None

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        """The first captured graph (None on the CPU or before capture)."""
        return self.graphs[0] if self.graphs else None

    def capture(self, pool=None) -> float:
        """Warm up and capture (on the CPU: one eager run); returns the
        seconds taken. ``pool``: a ``torch.cuda.graph_pool_handle()`` shared
        with the engine's other graphs. Raises ``RuntimeError`` naming the
        entry point and its buffers if a run or the capture fails."""
        t0 = time.perf_counter()
        try:
            if self.device.type == "cuda":
                self._capture_cuda(pool)
            else:
                with recording(_Sequence()) as rec:
                    self.fn()
                self.sequence = rec.ops
        except Exception as e:
            raise RuntimeError(f"warmup failed for '{self.name}' "
                               f"({describe(self.buffers)}): {e}") from e
        return time.perf_counter() - t0

    def _capture_cuda(self, pool) -> None:
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for _ in range(WARM_RUNS):
                self.fn()
        if not self.split:
            graph = torch.cuda.CUDAGraph()
            # entering synchronizes the device, so the warm-up runs are done
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                out = self.fn()
            self.graphs, self.output = [graph], out
            return
        seg = _Segments(pool if pool is not None
                        else torch.cuda.graph_pool_handle())
        with torch.cuda.stream(stream), recording(seg):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            seg.begin()
            try:
                out = self.fn()
                seg.end()
            except BaseException:
                seg.abandon()
                raise
        torch.cuda.synchronize()
        self.graphs, self.collectives = seg.graphs, seg.runs
        self.sequence, self.output = seg.ops, out

    def run(self) -> torch.Tensor:
        """One tick: replay the graphs with the collectives between them
        (CUDA) or call the function (CPU). The output is the static
        tensor, overwritten by the next run."""
        if self.device.type == "cpu":
            return self.fn()
        if not self.graphs:
            raise RuntimeError(f"'{self.name}' was not captured")
        last = len(self.collectives)
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < last:
                self.collectives[i]()
        return self.output
