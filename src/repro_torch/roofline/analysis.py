"""Roofline terms of one step, counted on ``meta`` tensors.

  compute    = flops / peak bf16 rate      (per card: a rank runs its own
  memory     = bytes / HBM rate             shard of the step, so the
  collective = coll_bytes / link rate       counts are already per card)

The port has no compiler cost model and no HLO. :class:`CostCounter` is a
``TorchDispatchMode`` that watches one step run on ``meta`` tensors (every
op dispatched, nothing computed) and counts:

* float ops of each aten op by ``torch.utils.flop_counter``'s formulas;
* the bytes each op reads and writes (its tensor inputs and outputs; views
  move nothing);
* each kernel operator (``repro_torch::*``, ``kernels/_op.py``) by
  :func:`kernel_terms`, the one formula of B1-B6's work, also used for the
  bound columns of ``chip_smoke.py``;
* each collective's result bytes by kind, keyed as the reference keys its
  HLO ops (``all-reduce`` counted twice: reduce-scatter then all-gather);
* the peak of live tensor bytes that the step's ops allocate.

The reference also reads collective bytes from partitioned HLO text
(``collective_bytes``); with no HLO here, the counter takes them from the
c10d ops instead.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.roofline import hw


@dataclasses.dataclass
class RooflineTerms:
    flops: float                  # per-card float ops
    bytes_hbm: float              # per-card
    bytes_coll: float             # per-card
    coll_breakdown: Dict[str, float]
    int_ops: float = 0.0          # per-card INTEGER-domain ops (int8 MACs /
    # XNOR-popcount words at 32 bits a word): B3 / B4's work

    @property
    def t_compute(self) -> float:
        return self.flops / hw.PEAK_FLOPS_BF16

    @property
    def t_int(self) -> float:
        return self.int_ops / hw.PEAK_OPS_INT8

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.bytes_coll / hw.LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "int": self.t_int,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_int, self.t_memory,
                   self.t_collective)

    def as_dict(self) -> dict:
        return dict(
            flops=self.flops,
            int_ops=self.int_ops,
            bytes_hbm=self.bytes_hbm,
            bytes_coll=self.bytes_coll,
            t_compute=self.t_compute,
            t_int=self.t_int,
            t_memory=self.t_memory,
            t_collective=self.t_collective,
            dominant=self.dominant,
            coll_breakdown=self.coll_breakdown,
        )


def integer_dense_ops(
    m: int, n_in: int, r: int, compute_path: str = "xnor"
) -> float:
    """Integer-op count of one tiled dense apply (u = x . T^T):

    * ``int8``: 2 * m * n_in * r, one int8 MAC (multiply + add) per (row,
      bit) pair;
    * ``xnor``: each of the m*r outputs reads ceil(n_in/32) packed words at
      ~2 word ops each (XOR + popcount); one 32-lane word op covers 32 bit
      positions, so the count is normalized to MAC-equivalents at the int8
      rate: 2 * m * r * ceil(n_in/32);
    * ``float`` contributes nothing here (its MACs are float ops).
    """
    if compute_path == "int8":
        return 2.0 * m * n_in * r
    if compute_path == "xnor":
        return 2.0 * m * r * ((n_in + 31) // 32)
    if compute_path == "float":
        return 0.0
    raise ValueError(f"unknown compute_path {compute_path!r}")


def combine_extrapolated(
    base: RooflineTerms, delta: RooflineTerms, extra_trips: int
) -> RooflineTerms:
    """total = base + extra_trips * delta."""
    add = lambda a, b: a + extra_trips * b
    coll = dict(base.coll_breakdown)
    for k, v in delta.coll_breakdown.items():
        coll[k] = coll.get(k, 0.0) + extra_trips * v
    return RooflineTerms(
        flops=add(base.flops, delta.flops),
        bytes_hbm=add(base.bytes_hbm, delta.bytes_hbm),
        bytes_coll=add(base.bytes_coll, delta.bytes_coll),
        coll_breakdown=coll,
        int_ops=add(base.int_ops, delta.int_ops),
    )


def subtract(a: RooflineTerms, b: RooflineTerms) -> RooflineTerms:
    coll = {k: max(0.0, v - b.coll_breakdown.get(k, 0.0))
            for k, v in a.coll_breakdown.items()}
    return RooflineTerms(
        flops=max(0.0, a.flops - b.flops),
        bytes_hbm=max(0.0, a.bytes_hbm - b.bytes_hbm),
        bytes_coll=max(0.0, a.bytes_coll - b.bytes_coll),
        coll_breakdown=coll,
        int_ops=max(0.0, a.int_ops - b.int_ops),
    )


def model_flops(cfg, cell, n_params_active: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference forward), global."""
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_params_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_params_active * tokens
    tokens = cell.global_batch * 1
    return 2.0 * n_params_active * tokens


# ---------------------------------------------------------------------------
# The kernels' work
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KernelWork:
    """One kernel call's work: ``ops`` at the rate of ``peak`` ("bf16",
    "f32" or "int8") and ``bytes`` moved (each input read once, each output
    written once)."""

    ops: float
    bytes: float
    peak: str

    def times_ms(self, card: hw.Card = hw.SXM):
        """(bytes ms, ops ms) on ``card``: the bytes over its HBM rate and the
        ops over its ``peak`` rate."""
        return 1e3 * self.bytes / card.hbm_bw, 1e3 * self.ops / card.peak(self.peak)

    def bound_ms(self, card: hw.Card = hw.SXM):
        """(least ms the card could take, "bytes" or "operations")."""
        t_bytes, t_ops = self.times_ms(card)
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _float_peak(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def kernel_terms(name: str, x_shape, packed_shape=None, dtype=torch.bfloat16,
                 *, out_hw=None, with_a: bool = False) -> KernelWork:
    """B1-B6's operations and bytes for one call on these operands:

    * "B1" / "B2": x (m, K) of ``dtype``, packed (r, K/32) int32 -> (m, r)
      f32: 2 m K r float ops;
    * "B3": sign words (m, W) int32, packed (r, W) -> (m, r) int32: 2 m r W
      word ops (``integer_dense_ops``' xnor count);
    * "B4": int8 q (m, K), packed (r, K/32) -> (m, r) int32: 2 m K r;
    * "B5": masters (p, q) of ``dtype`` (and an alpha source of the same
      shape ``with_a``) -> q/32 words and p alphas: 2 p q f32 ops (column
      sums and |A| sums);
    * "B6": x (N, Hp, Wp, C) of ``dtype``, packed (kh kw, r, C/32) ->
      (N, OH, OW, r) f32 at ``out_hw``: 2 N OH OW kh kw C r.
    """
    numel = lambda shape: float(torch.Size(shape).numel())
    if name in ("B1", "B2", "B3", "B4"):
        (m, k), (r, words) = x_shape, packed_shape
        read = numel(x_shape) * dtype.itemsize + r * words * 4
        out = m * r * 4
        if name == "B3":
            return KernelWork(2.0 * m * r * words, read + out, "int8")
        if name == "B4":
            return KernelWork(2.0 * m * k * r, read + out, "int8")
        return KernelWork(2.0 * m * k * r, read + out, _float_peak(dtype))
    if name == "B5":
        p, q = x_shape
        read = p * q * dtype.itemsize * (2 if with_a else 1)
        return KernelWork(2.0 * p * q, read + q // 8 + p * 4, "f32")
    if name == "B6":
        n, c = x_shape[0], x_shape[3]
        taps, r, words = packed_shape
        m = n * out_hw[0] * out_hw[1]
        read = numel(x_shape) * dtype.itemsize + taps * r * words * 4
        return KernelWork(2.0 * m * taps * c * r, read + m * r * 4,
                          _float_peak(dtype))
    raise ValueError(f"kernel_terms: unknown kernel {name!r}")


# operator name (``repro_torch::<name>``) -> (kernel id, its work from the
# operator's arguments)
KERNEL_OPS = {
    "tiled_matvec_unique": ("B1", lambda x, packed, *_: kernel_terms(
        "B1", x.shape, packed.shape, x.dtype)),
    "tiled_matmul_unique": ("B2", lambda x, packed, *_: kernel_terms(
        "B2", x.shape, packed.shape, x.dtype)),
    "tiled_xnor_matvec_unique": ("B3", lambda a, packed, *_: kernel_terms(
        "B3", a.shape, packed.shape, a.dtype)),
    "tiled_int8_matvec_unique": ("B4", lambda q, packed, *_: kernel_terms(
        "B4", q.shape, packed.shape, q.dtype)),
    "tile_construct": ("B5", lambda w, a=None: kernel_terms(
        "B5", w.shape, None, w.dtype, with_a=a is not None)),
    "tiled_conv_unique": ("B6", lambda x, packed, kernel, stride, out_hw, *_:
                          kernel_terms("B6", x.shape, packed.shape, x.dtype,
                                       out_hw=out_hw)),
}

# c10d operator -> the reference's collective kind
COLLECTIVES = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "barrier": "barrier",
}

# ops that allocate without reading or writing a value
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "lift_fresh")


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


class CostCounter(TorchDispatchMode):
    """Counts one region's work (see the module docstring): ``flops``,
    ``int_ops``, ``bytes_hbm``, ``kernels`` {kernel id: calls},
    ``kernel_work`` {kernel id: [ops, bytes]}, ``coll_bytes`` and
    ``coll_calls`` by kind, and ``peak_bytes``: the most bytes that the
    region's ops held alive at once, above what was alive before it."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self._flop_registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0.0
        self.int_ops = 0.0
        self.bytes_hbm = 0.0
        self.kernels: Dict[str, int] = {}
        self.kernel_work: Dict[str, list] = {}
        self.coll_bytes: Dict[str, float] = {}
        self.coll_calls: Dict[str, int] = {}
        self.live_bytes = 0.0
        self.peak_bytes = 0.0
        self._live: Dict[int, float] = {}

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0.0)

    def _track(self, out, inputs) -> None:
        """Count the new storages among an op's outputs (a view or an
        in-place result shares its input's)."""
        held = {t.untyped_storage()._cdata for t in inputs}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in held:
                continue
            n = float(st.nbytes())
            self._live[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "c10d":
            kind = COLLECTIVES.get(name)
            if kind is not None:
                moved = _nbytes(_tensors(args[0] if args else ()))
                factor = 2.0 if kind == "all-reduce" else 1.0
                self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) + factor * moved
                self.coll_calls[kind] = self.coll_calls.get(kind, 0) + 1
            return out
        if ns == "repro_torch" and name in KERNEL_OPS:
            kid, terms = KERNEL_OPS[name]
            work = terms(*args, **kwargs)
            self.kernels[kid] = self.kernels.get(kid, 0) + 1
            acc = self.kernel_work.setdefault(kid, [0.0, 0.0])
            acc[0] += work.ops
            acc[1] += work.bytes
            if work.peak == "int8":
                self.int_ops += work.ops
            else:
                self.flops += work.ops
            self.bytes_hbm += work.bytes
            self._track(out, _tensors(args))
            return out
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += float(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        inputs = _tensors((args, kwargs))
        if not func.is_view and name.split(".")[0] not in _NO_TRAFFIC:
            self.bytes_hbm += _nbytes(inputs) + _nbytes(_tensors(out))
        self._track(out, inputs)
        return out

    def terms(self) -> RooflineTerms:
        return RooflineTerms(
            flops=self.flops,
            bytes_hbm=self.bytes_hbm,
            bytes_coll=sum(self.coll_bytes.values()),
            coll_breakdown=dict(self.coll_bytes),
            int_ops=self.int_ops,
        )

    def as_dict(self) -> dict:
        return dict(self.terms().as_dict(), kernels=dict(self.kernels),
                    coll_calls=dict(self.coll_calls), peak_bytes=self.peak_bytes)
