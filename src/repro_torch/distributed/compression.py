"""Gradient compression for the data-parallel reduction (port of
``repro/distributed/compression.py``).

Two codecs, and an explicit data-parallel train step that uses them:

  * EF-sign (1 bit/coordinate + one scalar): sign of (grad + error
    feedback), scaled by the mean magnitude; the residual stays in the
    per-worker error accumulator, which makes the method convergent
    (Karimireddy et al., "Error Feedback Fixes SignSGD").
  * int8 (8 bits/coordinate + one scalar per tensor): symmetric linear
    quantization of the local gradient before the reduction.

The reference runs data parallelism explicitly under ``shard_map``; here a
rank of a ``torch.distributed`` job holds the replicated state and its
rows of the batch, encodes its local gradient, and the decoded payloads
are summed over the mesh dim's process group (``all_reduce``) and divided
by its size, as the reference's ``psum`` of decoded payloads. On the CPU
the EF-sign scale is summed in the order of XLA's tree reduction
(``core.ordered.ordered_sum_all``): its payload equals the reference's bit
for bit on a vector; over a tensor of more dims XLA's CPU emitter at times
vectorizes the sum in an order of its own, and the scale is then within a
few ulps (``tests/test_torch_compression.py`` holds the bound). The int8
codec is exact.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ordered import ordered_sum_all
from repro_torch.distributed.sharding import mesh_extents, sum_over
from repro_torch.nn import module as mod


# ---------------------------------------------------------------------------
# codecs (pure per-worker math; reduction = sum of decoded payloads)
# ---------------------------------------------------------------------------
def _mean_abs(c: torch.Tensor) -> torch.Tensor:
    if c.device.type == "cpu":
        return ordered_sum_all(c.abs()) * float(np.float32(1) / np.float32(c.numel()))
    return c.abs().mean()


def ef_sign_encode(g: torch.Tensor, err: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (decoded payload to reduce, new error state).

    payload = sign(g + err) * mean|g + err|  (1 bit + 1 scalar on the wire)
    """
    c = g + err
    payload = torch.sign(c) * _mean_abs(c)
    return payload, c - payload


def int8_encode(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 codes, f32 scale). Wire cost: 8 bits + 1 scalar."""
    amax = g.abs().max()
    # the reference's jitted division by 127 is a multiplication by the f32
    # reciprocal
    scale = torch.clamp(amax, min=1e-12) * float(np.float32(1) / np.float32(127))
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def wire_bits(kind: str, n: int) -> int:
    """Per-worker bits on the wire for an n-element gradient."""
    return {"none": 32 * n, "int8": 8 * n + 32, "ef_sign": n + 32}[kind]


# ---------------------------------------------------------------------------
# explicit-DP train step with compressed reduction
# ---------------------------------------------------------------------------
class CompressionState(NamedTuple):
    """Error-feedback accumulators (zeros for int8/none)."""

    error: Any

    @staticmethod
    def init(params, kind: str) -> "CompressionState":
        if kind == "ef_sign":
            z = mod.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
        else:
            z = mod.map_tree(lambda p: torch.zeros((), dtype=torch.float32,
                                                   device=p.device), params)
        return CompressionState(error=z)


def compressed_psum_mean(grads, err_tree, *, kind: str, mesh, axis: str):
    """Per-rank compress -> sum over ``axis`` of ``mesh`` -> mean.

    Returns (reduced grads, new error tree). ``kind`` in
    {"none", "int8", "ef_sign"}."""
    n = mesh_extents(mesh)[axis]

    def one(g, e):
        if kind == "none":
            return sum_over(g.clone(), mesh, (axis,)) / n, e
        if kind == "int8":
            q, s = int8_encode(g)
            return sum_over(int8_decode(q, s), mesh, (axis,)) / n, e
        if kind == "ef_sign":
            payload, new_e = ef_sign_encode(g, e)
            return sum_over(payload, mesh, (axis,)) / n, new_e
        raise ValueError(kind)

    red: dict = {}
    new_err: dict = {}
    for path, g in mod.walk(grads):
        r, e = one(g, mod.get_path(err_tree, path))
        mod.set_path(red, path, r)
        mod.set_path(new_err, path, e)
    return red, new_err


class CompressedMean:
    """``compressed_psum_mean`` as a ``build_train_step(grad_reduce=)``: it
    keeps the ``CompressionState`` between steps (``.state``)."""

    def __init__(self, state: CompressionState, *, kind: str, mesh,
                 axis: str = "data"):
        self.state, self.kind, self.mesh, self.axis = state, kind, mesh, axis

    def __call__(self, grads):
        red, err = compressed_psum_mean(grads, self.state.error, kind=self.kind,
                                        mesh=self.mesh, axis=self.axis)
        self.state = CompressionState(error=err)
        return red


def build_dp_train_step(
    loss_fn: Callable,
    optimizer,
    mesh,
    *,
    compression: str = "ef_sign",
    dp_axis: str = "data",
    clip_norm: Optional[float] = 1.0,
):
    """Explicit data-parallel train step over ``mesh``'s ``dp_axis``:
    ``build_train_step(mesh=, grad_reduce=CompressedMean(...))``.

    Params and optimizer state are replicated over ``dp_axis``; each rank
    computes local grads on its rows of the batch, the reduction goes
    through the chosen codec, and every rank applies the identical update.
    The returned step takes and returns a (TrainState, CompressionState)
    pair: ``step(state, comp, batch) -> (state, comp, metrics)``, with the
    loss averaged over ``dp_axis``."""
    from repro_torch.train.step import build_train_step

    reduce = CompressedMean(None, kind=compression, mesh=mesh, axis=dp_axis)
    inner = build_train_step(loss_fn, optimizer, clip_norm=clip_norm,
                             mesh=mesh, dp_axis=dp_axis, grad_reduce=reduce)

    def step(state, comp: CompressionState, batch):
        reduce.state = comp
        state, metrics = inner(state, batch)
        return state, reduce.state, {"loss": metrics["loss"],
                                     "grad_norm": metrics["grad_norm"]}

    return step
