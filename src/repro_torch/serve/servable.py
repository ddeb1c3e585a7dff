"""ServableModel: the model <-> engine serving contract (port of
``repro/serve/servable.py``).

The contract has three parts:

* **probes**: ``has_full_attn`` / ``has_recurrent_state`` /
  ``has_cross_attn``, read once when the engine is built to decide which
  host-side machinery it stands up (the attention page pool, the per-slot
  reset, the cross-attention pool and the ENCODE phase).
* **cache families**: ``cache_families()`` returns :class:`CacheFamily`
  descriptors, how each family of decode state is stored (paged pool or
  per-slot rows) and whether decode may write it (cross-attention K/V is
  read-only after the encode phase). The engine reports them per family
  in ``stats()``.
* **tick methods**: ``init_caches`` / ``prefill`` / ``decode_step`` /
  ``extend`` and the per-slot walkers (``merge_caches``,
  ``reset_slot_caches``, ``snapshot_slot_caches``,
  ``restore_slot_caches``). The engine's tick functions call only these.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, Tuple

# Model families the serving stack can drive, with the engine path each
# takes. UnservableModelError lists them, so an unsupported config fails
# with the menu attached.
SERVABLE_FAMILIES = {
    "dense": "DecoderLM; full-attention KV in the paged pool",
    "moe": "DecoderLM; expert tiles (E, r, words), drop-free serve dispatch",
    "ssm": "DecoderLM; per-slot (h, conv) state, boundary snapshots",
    "hybrid": "DecoderLM; pattern blocks mix paged KV + recurrent state",
    "vlm": "DecoderLM; early-fusion image embeddings, paged KV",
    "encdec": "EncDecModel; ENCODE phase + read-only cross-attention pool",
}

# The attribute surface the engine touches. ``ensure_servable`` checks
# presence, not signatures; the parity tests check semantics.
REQUIRED_ATTRS: Tuple[str, ...] = (
    "has_full_attn",
    "has_recurrent_state",
    "has_cross_attn",
    "cache_families",
    "init_caches",
    "prefill",
    "decode_step",
    "extend",
    "merge_caches",
    "reset_slot_caches",
    "snapshot_slot_caches",
    "restore_slot_caches",
)


@dataclasses.dataclass(frozen=True)
class CacheFamily:
    """How one family of decode-cache state is stored and written.

    ``paged`` families live in a shared page pool addressed through
    per-slot page-table rows; the others are per-slot rows. ``read_only``
    families are written exactly once (the encode phase) and only read by
    decode and extend."""

    name: str                  # "self_attn" | "cross_attn" | "recurrent"
    paged: bool
    read_only: bool = False


class UnservableModelError(TypeError):
    """A model (or config family) the engine cannot drive. Carries the
    menu of servable families, so the message says what would work."""

    def __init__(self, what: str, missing: Tuple[str, ...] = ()):
        menu = "; ".join(f"{k}: {v}" for k, v in SERVABLE_FAMILIES.items())
        detail = (
            f" (missing: {', '.join(missing)})" if missing else ""
        )
        super().__init__(
            f"{what} does not satisfy the ServableModel contract{detail}. "
            f"Servable families — {menu}"
        )
        self.missing = missing


class ServableModel(Protocol):
    """Typing surface of the contract (the runtime check is
    :func:`ensure_servable`)."""

    has_full_attn: bool
    has_recurrent_state: bool
    has_cross_attn: bool

    def cache_families(self) -> Tuple[CacheFamily, ...]: ...
    def init_caches(self, batch, max_len, dtype, *, page_tokens=None,
                    n_pages=None, **kw): ...
    def prefill(self, params, batch, max_len): ...
    def decode_step(self, params, tokens, caches, lengths, **kw): ...
    def extend(self, params, tokens, caches, lengths, n_new, **kw): ...
    def merge_caches(self, old, new, keep, paged=False): ...
    def reset_slot_caches(self, caches, slot, paged=False): ...
    def snapshot_slot_caches(self, caches, slot): ...
    def restore_slot_caches(self, caches, slot, snaps): ...


def ensure_servable(model) -> object:
    """Raise :class:`UnservableModelError` (listing what is missing and the
    servable-family menu) unless ``model`` exposes the whole contract;
    returns the model."""
    missing = tuple(a for a in REQUIRED_ATTRS if not hasattr(model, a))
    if missing:
        raise UnservableModelError(type(model).__name__, missing)
    return model
