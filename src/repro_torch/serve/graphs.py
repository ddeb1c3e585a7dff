"""Captured tick programs: the port's counterpart of the reference engine's
ahead-of-time compiled executables (``repro/serve/engine.py`` ``warmup``
and ``self._aot``).

The engine has two fixed-shape entry points, the ``(n_slots, 1)`` decode
tick and the ``(n_slots, chunk_tokens)`` extend tick. Each is a function of
no arguments over static tensors (the params, the K/V pools, lengths and
tokens, and one device buffer per per-tick input) that writes the engine's
state in place and returns the tick's logits. A :class:`TickGraph` owns one
such function, the static buffers it reads and writes, its static output
and, on a CUDA engine, a ``torch.cuda.CUDAGraph`` of it:

* Capture follows PyTorch's whole-network recipe: ``WARM_RUNS`` eager runs
  on a side stream (they load the kernel libraries, fill every planner's
  cache and set up cuBLAS's workspace for that stream), then one capture
  on the same stream into a memory pool that the engine's graphs share.
  Every later :meth:`TickGraph.run` is one ``replay()``. A replay runs none
  of the function's Python, so the kernel wrappers' ``launches`` counters
  do not move.
* On a CPU engine there is no graph: :meth:`TickGraph.run` calls the
  function eagerly on the same static buffers, so the host tests exercise
  the buffer plumbing.

The caller fills the per-tick input buffers in place (``copy_``) before
``run()``: a copy from pageable host memory cannot happen inside a
capture, and a rebound tensor would not be the one the graph reads.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

# eager runs before a capture; the second finds every lazy set-up done
WARM_RUNS = 2


def describe(buffers: Dict[str, torch.Tensor]) -> str:
    """'tokens int64[3,1], ptab int32[3,6], ...' for error messages."""
    return ", ".join(
        f"{name} {str(t.dtype).removeprefix('torch.')}[{','.join(map(str, t.shape))}]"
        for name, t in buffers.items())


class TickGraph:
    """One entry point: ``fn`` over the static ``buffers`` (every tensor it
    reads or writes besides the params), its static output, and on a CUDA
    device the captured graph."""

    def __init__(self, name: str, fn: Callable[[], torch.Tensor],
                 buffers: Dict[str, torch.Tensor], device: torch.device):
        self.name = name
        self.fn = fn
        self.buffers = buffers
        self.device = torch.device(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.output: Optional[torch.Tensor] = None

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
                self.fn()
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
        graph = torch.cuda.CUDAGraph()
        # entering synchronizes the device, so the warm-up runs are done
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            out = self.fn()
        self.graph, self.output = graph, out

    def run(self) -> torch.Tensor:
        """One tick: replay the graph (CUDA) or call the function (CPU).
        The output is the static tensor, overwritten by the next run."""
        if self.device.type == "cpu":
            return self.fn()
        if self.graph is None:
            raise RuntimeError(f"'{self.name}' was not captured")
        self.graph.replay()
        return self.output
