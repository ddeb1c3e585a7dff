"""Kernel B9: the f64 partial softmax of a "seq" attention layer over one
rank's keys, or, for one part, its attention output rounded once.

The port's own kernel; it replaces no TPU kernel. The reference attends a
"seq" layer through XLA. The port's mesh splits a "seq" layer's cache rows
over ranks, each rank returns its partial softmax (the row maximum m, the
sum of exponentials l and the unnormalised output o) and the ranks merge
them (``distributed.sharding.merge_partials``), all in f64 so that every
split of the keys rounds to one value. B9 computes one part in one pass
over the rank's K/V (bf16 / f32, or int8 codes with their f32 scales in
the reference's scale-factored order); on one card a "seq" layer attends
as the merge's one part, the kernel's epilogue dividing by l and rounding
once. So one card and every mesh give the same f32 / bf16 values. The
CUDA source is ``csrc/seq_attend.cu``; its header says what bounds the
kernel on an H100 (K/V bytes against f64 arithmetic) and how the design
shares each key's read between the G query heads of its K/V head.

The wrapper calls the operator ``repro_torch::seq_attend``
(``kernels/_op.py``), which launches the kernel for CUDA tensors and runs
the plain PyTorch version (:func:`seq_attend_plain`, the arithmetic of the
mesh's CPU path) only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.distributed.sharding import merge_softmax_parts
from repro_torch.kernels import _build
from repro_torch.kernels._op import kernel_op
from repro_torch.kernels.tiled_matmul import _sm_count

NEG_INF = -1e30
THREADS = 256          # csrc/seq_attend.cu kThreads: hd must divide it
MAX_HD = 256
ROWS, KEYS = 16, 64    # kRows (query, head) rows a block, kKeys keys a tile
_Q_KINDS = {torch.bfloat16: 0, torch.float32: 1}
_KV_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
_MODES = {None: 0, torch.float32: 1, torch.bfloat16: 2}


def partial_softmax(scores: torch.Tensor, mask_b: torch.Tensor):
    """f64 scores (B, K, G, S, T) over a rank's keys -> (e, m, l): e =
    exp(s - m) at the valid keys and exactly 0 at the others (a masked
    score is NEG_INF, not -inf, so a row with no valid key here would
    otherwise weigh every key exp(0) = 1), m the row's largest score
    (NEG_INF without a valid key) and l = sum e, both (B, S, K, G)."""
    scores = torch.where(mask_b, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    e = torch.where(mask_b, torch.exp(scores - m), 0.0)
    return e, m[..., 0].permute(0, 3, 1, 2), e.sum(-1).permute(0, 3, 1, 2)


def _kv_scales(s: torch.Tensor) -> torch.Tensor:
    """(B, T, K) f32 scales -> (B, K, 1, 1, T) f64, against (B, K, G, S, T)."""
    return s.double().permute(0, 2, 1)[:, :, None, None, :]


def seq_attend_plain(q, k, v, ks, vs, mask, scale: float,
                     out_dtype: Optional[torch.dtype] = None):
    """The plain PyTorch version of B9: q (B, S, K, G, hd), k, v (B, T, K,
    hd) (int8 codes with ``ks`` / ``vs`` (B, T, K) f32, else None), mask
    (B, S, T) or (S, T), True = attend -> (o (B, S, K, G, hd), m, l (B, S,
    K, G)), all f64: s = (q . k) scale, or ((q . codes) ks) scale; o = sum
    e v, or sum (e vs) codes. With ``out_dtype`` o is the one part merged
    (``merge_softmax_parts``: o / l, 0 where no key is valid) and rounded
    to it."""
    mask_b = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
    scores = torch.einsum("bskgh,btkh->bkgst", q.double(), k.double())
    if ks is not None:
        scores = scores * _kv_scales(ks)
    e, m, l = partial_softmax(scores * scale, mask_b)
    if vs is not None:
        e = e * _kv_scales(vs)
    o = torch.einsum("bkgst,btkh->bskgh", e, v.double())
    if out_dtype is not None:
        o = merge_softmax_parts(torch.cat([o, m[..., None], l[..., None]], -1)[None])
        o = o.to(out_dtype)
    return o, m, l


def near_rounding_boundary(x: torch.Tensor, dtype: torch.dtype,
                           tol: float) -> torch.Tensor:
    """Where the f64 values ``x`` lie within ``tol`` of a midpoint between
    two neighbours of ``dtype`` (f32 or bf16): there two f64 sums that
    agree to ``tol`` (the kernel's and the plain version's, in their own
    orders) may round to neighbouring values. A bool mask like ``x``."""
    bits = {torch.float32: 23, torch.bfloat16: 7}[dtype]
    y = x.to(dtype).double()
    ulp = torch.exp2(torch.floor(torch.log2(y.abs().clamp_min(1e-300))) - bits)
    dist = torch.minimum((x - (y + ulp / 2)).abs(), (x - (y - ulp / 2)).abs())
    return (dist <= tol) & (x != y)


def _check(q, k, v, ks, vs, mask) -> None:
    what = "seq_attend"
    if q.ndim != 5 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: q must be (B, S, K, G, hd) and k, v (B, T, K, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, kh, _, hd = q.shape
    if k.shape[0] != b or k.shape[2] != kh or k.shape[3] != hd:
        raise ValueError(f"{what}: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in _Q_KINDS or k.dtype not in _KV_KINDS or v.dtype != k.dtype:
        raise TypeError(f"{what}: q {q.dtype} (bf16 / f32), k {k.dtype}, v "
                        f"{v.dtype} (bf16 / f32 / int8, one type)")
    if (ks is None) != (k.dtype != torch.int8) or (ks is None) != (vs is None):
        raise ValueError(f"{what}: int8 codes take ks and vs, other K/V none")
    if ks is not None and (ks.shape != k.shape[:3] or vs.shape != ks.shape
                           or ks.dtype != torch.float32 or vs.dtype != torch.float32):
        raise ValueError(f"{what}: ks, vs must be f32 {tuple(k.shape[:3])}")
    if mask.dtype != torch.bool or mask.shape[-2:] != (s, k.shape[1]):
        raise ValueError(f"{what}: mask must be bool (B, S, T) or (S, T), got "
                         f"{mask.dtype} {tuple(mask.shape)}")


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, bound launch function), built and loaded on first use."""
    lib = _build.load("seq_attend")
    fn = lib.tbn_seq_attend
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_double]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def key_split(b: int, s: int, kh: int, g: int, t: int, sms: int) -> int:
    """The keys each block of a B9 call takes (a multiple of KEYS): a
    (slot, K/V head, tile of ROWS rows) grid with fewer blocks than SMs
    splits its keys over more blocks, down to one tile each, whose partials
    a second pass merges in order."""
    base = b * kh * -(-(s * g) // ROWS)
    splits = min(max(1, -(-sms // base)), -(-t // KEYS))
    return -(-(-(-t // splits)) // KEYS) * KEYS


def _outputs(q, out_dtype):
    b, s, kh, g, hd = q.shape
    o = q.new_empty(q.shape, dtype=out_dtype or torch.float64)
    return o, q.new_empty((b, s, kh, g), dtype=torch.float64), \
        q.new_empty((b, s, kh, g), dtype=torch.float64)


def _launch(q, k, v, ks, vs, mask, scale: float, out_dtype):
    if q.device.type != "cuda":
        raise ValueError(f"seq_attend: no kernel for device {q.device}")
    hd = q.shape[-1]
    if hd > MAX_HD or THREADS % hd:
        raise ValueError(f"seq_attend: head dim {hd} must divide {THREADS}")
    if out_dtype not in _MODES:
        raise TypeError(f"seq_attend: out_dtype {out_dtype} (None, f32 or bf16)")
    ts = [t for t in (q, k, v, ks, vs) if t is not None]
    if any(t.device != q.device or not t.is_contiguous() for t in ts):
        raise ValueError("seq_attend: q, k, v, ks, vs must be contiguous on one device")
    b, s, kh, g, _ = q.shape
    t = k.shape[1]
    m8 = mask.expand(b, s, t).contiguous().view(torch.uint8)
    o, m, l = _outputs(q, out_dtype)
    per_split = key_split(b, s, kh, g, t, _sm_count(q.device.index))
    splits = -(-t // per_split)
    ws = (torch.empty((splits, b * s * kh * g, hd + 2), dtype=torch.float64,
                      device=q.device) if splits > 1 else None)
    lib, launch = _launcher()
    ptr = lambda x: None if x is None else x.data_ptr()
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ks), ptr(vs),
                 m8.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(), ptr(ws),
                 b, s, t, kh, g, hd, per_split, float(scale), _Q_KINDS[q.dtype],
                 _KV_KINDS[k.dtype], _MODES[out_dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "seq_attend")
    seq_attend.launches += 1
    return o, m, l


def seq_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               ks: Optional[torch.Tensor], vs: Optional[torch.Tensor],
               mask: torch.Tensor, scale: float,
               out_dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A "seq" layer's attention over one rank's keys: q (B, S, K, G, hd)
    bf16 / f32; k, v (B, T, K, hd) bf16 / f32, or int8 codes with ks, vs
    (B, T, K) f32 (else None); mask (B, S, T) or (S, T) bool -> (o, m, l):
    the f64 partial softmax (``out_dtype`` None) or, with ``out_dtype``
    (f32 / bf16), o the one part's output rounded once (m, l f64 either
    way). Launches kernel B9 for CUDA tensors; CPU tensors take
    :func:`seq_attend_plain`."""
    _check(q, k, v, ks, vs, mask)
    return _seq_attend_op(q, k, v, ks, vs, mask, float(scale), out_dtype)


_seq_attend_op = kernel_op(
    "seq_attend",
    "(Tensor q, Tensor k, Tensor v, Tensor? ks, Tensor? vs, Tensor mask, "
    "float scale, ScalarType? out_dtype) -> (Tensor, Tensor, Tensor)",
    _launch, seq_attend_plain,
    lambda q, k, v, ks, vs, mask, scale, out_dtype: _outputs(q, out_dtype))
seq_attend.launches = 0
