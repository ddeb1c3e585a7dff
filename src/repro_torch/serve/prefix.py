"""Radix trie over prompt token ids and the encoder-output cache: the
engine's shared-prefix reuse (port of ``repro/serve/prefix.py``, which is
pure Python; the port keeps its own copy).

Trie nodes live at PAGE granularity: each non-root node is one
``page_tokens``-token edge, so a node at depth d pins the cache state of the
prefix ``tokens[: d * page_tokens]``, one resource per cache family:

* ``page``     the attention-pool page id holding that page's K/V rows in
               every full-attention layer (refcounted by the
               :class:`~repro_torch.serve.kvpool.KVPool`; the trie holds one
               reference per node). None for a model without full attention.
* ``snapshot`` the per-slot families' state at exactly the page boundary
               (SSM and RG-LRU (h, conv) carries, windowed-attention ring
               rows): a tree of device tensors that the node OWNS. The
               engine clones a captured snapshot's static output before it
               hands it over, so a later replay cannot overwrite a node.
               None for a stateless (pure full-attention) model.

Admission matches the longest pinned prefix (page-aligned, capped at
``len(prompt) - 1`` so at least one prompt token runs through the model to
give the first-token logits), maps the matched page run into the slot's
page table and restores the deepest matched snapshot: O(1) in the prefix
length, no re-prefill, no K/V copy. Retirement publishes the finished
prompt's complete pages back as new nodes.

Eviction is LRU over LEAF nodes only (an inner node's children extend it,
so a path dies bottom-up). Evicting a node drops the trie's page reference
(the page frees once no live slot maps it) and its snapshot. The node
count is capped (``max_nodes``) because snapshots hold device memory, and
the engine also evicts on demand when the page pool runs dry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.serve.kvpool import KVPool


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a snapshot tree (lists, dicts, None leaves)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(t) for t in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(t) for t in tree)
    return 0


@dataclasses.dataclass(eq=False)
class PrefixNode:
    key: Tuple[int, ...]                 # this node's page_tokens token ids
    parent: Optional["PrefixNode"]
    depth: int                           # pages from root (root = 0)
    page: Optional[int] = None           # attention pool page id
    snapshot: Any = None                 # per-slot state tree at the boundary
    last_used: int = 0
    children: Dict[Tuple[int, ...], "PrefixNode"] = dataclasses.field(
        default_factory=dict)


class PrefixTrie:
    def __init__(self, page_tokens: int, pool: Optional[KVPool] = None,
                 max_nodes: int = 512):
        if page_tokens <= 0:
            raise ValueError(f"page_tokens must be positive: {page_tokens}")
        if max_nodes < 1:
            raise ValueError(f"max_nodes must be >= 1: {max_nodes}")
        self.pt = page_tokens
        self.pool = pool
        self.max_nodes = max_nodes
        self.root = PrefixNode(key=(), parent=None, depth=0)
        self._nodes: List[PrefixNode] = []     # every non-root node
        self.evictions = 0
        # admission lookups: a ``match`` that pinned at least one page is a
        # hit (the telemetry's serve_prefix_lookups_total reads these);
        # ``probe`` is advisory and uncounted
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def _walk(self, tokens, require_snapshot: bool) -> List[PrefixNode]:
        """The matched node path, capped at (len - 1) // page_tokens pages
        and, with ``require_snapshot``, cut back to the deepest node that
        has a snapshot (the restore reads only the last)."""
        toks = [int(t) for t in tokens]
        node, path = self.root, []
        for i in range((len(toks) - 1) // self.pt):
            child = node.children.get(tuple(toks[i * self.pt:(i + 1) * self.pt]))
            if child is None:
                break
            path.append(child)
            node = child
        best = len(path) - 1
        while best >= 0 and require_snapshot and path[best].snapshot is None:
            best -= 1
        return path[: best + 1]

    def match(self, tokens, *, require_snapshot: bool = False,
              now: int = 0) -> List[PrefixNode]:
        """Longest pinned page-aligned prefix of ``tokens`` as the node path
        from the shallowest matched page down; touches the path's recency."""
        path = self._walk(tokens, require_snapshot)
        if path:
            self.hits += 1
        else:
            self.misses += 1
        for n in path:
            n.last_used = now
        return path

    def probe(self, tokens, *, require_snapshot: bool = False) -> int:
        """How many tokens a ``match`` would serve, WITHOUT touching recency
        (the scheduler probes every waiting candidate every tick: a touch
        would keep a merely queued prefix warm and starve eviction)."""
        return len(self._walk(tokens, require_snapshot)) * self.pt

    def insert(self, tokens, pages: Optional[List[int]],
               snapshots: Dict[int, Any], *, now: int = 0) -> int:
        """Publish a finished prompt's complete pages.

        ``tokens`` is page-aligned; ``pages[i]`` is the slot's pool page of
        page i (the trie RETAINS it; the caller releases its own reference
        as usual), ``snapshots[boundary]`` the state captured when prefill
        crossed ``boundary`` tokens. An existing node keeps its page (first
        publisher wins) but a missing snapshot is backfilled, or a node
        republished after an eviction would cap the stateful match depth at
        its boundary for good. Returns the number of new nodes."""
        if len(tokens) % self.pt:
            raise ValueError(f"insert of {len(tokens)} tokens is not "
                             f"page-aligned (page_tokens={self.pt})")
        toks = [int(t) for t in tokens]
        node, created = self.root, 0
        protect = set()
        for i in range(len(toks) // self.pt):
            key = tuple(toks[i * self.pt:(i + 1) * self.pt])
            child = node.children.get(key)
            if child is None:
                if len(self._nodes) >= self.max_nodes and not self.evict_one(
                        exclude=protect | {node}):
                    break                      # cap hit, nothing evictable
                child = PrefixNode(
                    key=key, parent=node, depth=node.depth + 1,
                    page=pages[i] if pages else None,
                    snapshot=snapshots.get((i + 1) * self.pt), last_used=now)
                if child.page is not None:
                    self.pool.retain(child.page)
                node.children[key] = child
                self._nodes.append(child)
                created += 1
            else:
                child.last_used = now
                if child.snapshot is None:
                    child.snapshot = snapshots.get((i + 1) * self.pt)
            protect.add(child)
            node = child
        return created

    def evict_one(self, exclude=()) -> bool:
        """Detach the least-recently-used leaf, release its page reference
        and drop its snapshot. False when no leaf is evictable."""
        victim = None
        for n in self._nodes:
            if n.children or n in exclude:
                continue
            if victim is None or n.last_used < victim.last_used:
                victim = n
        if victim is None:
            return False
        victim.parent.children.pop(victim.key)
        self._nodes.remove(victim)
        if victim.page is not None:
            self.pool.release(victim.page)
        victim.snapshot = None
        self.evictions += 1
        return True

    def clear(self) -> None:
        while self.evict_one():
            pass

    def held_pages(self) -> List[int]:
        return [n.page for n in self._nodes if n.page is not None]

    def snapshot_bytes(self) -> int:
        """Device bytes of the snapshots the trie holds."""
        return sum(tree_bytes(n.snapshot) for n in self._nodes)


# ---------------------------------------------------------------------------
# encoder-output reuse (encoder-decoder serving)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class _EncEntry:
    pages: List[int]            # cross-pool page run holding the K/V
    enc_len: int                # valid memory rows (the decode-time mask)
    last_used: int = 0


class EncoderCache:
    """Digest-keyed cache of encoded sources in CROSS-POOL pages.

    The token trie cannot serve an encoder-decoder model: decoder
    self-attention K/V depends on the cross-attended memory, so a prompt
    prefix computed against one source is wrong for another. The encoder's
    output is reusable: two requests over the same source (same frame
    bytes, keyed by digest) share the cross pages verbatim, since those are
    read-only after the ENCODE phase and independent of the prompt. A hit
    maps the whole run into the slot's cross page table and skips ENCODE.

    The trie's refcount discipline: one pool reference per page per entry,
    the mapped slot its own; eviction is LRU over whole entries."""

    def __init__(self, pool: KVPool, max_entries: int = 128):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1: {max_entries}")
        self.pool = pool
        self.max_entries = max_entries
        self._entries: Dict[bytes, _EncEntry] = {}
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, digest: bytes) -> bool:
        return digest in self._entries

    def get(self, digest: bytes, *, now: int = 0) -> Optional[_EncEntry]:
        """Hit -> the entry with every page RETAINED for the caller, who
        releases them at slot teardown like any mapped page."""
        e = self._entries.get(digest)
        if e is None:
            return None
        for p in e.pages:
            self.pool.retain(p)
        e.last_used = now
        return e

    def put(self, digest: bytes, pages: List[int], enc_len: int, *,
            now: int = 0) -> bool:
        """Publish a finished encode's page run (first publisher wins).
        Retains every page; evicts LRU past the cap."""
        if digest in self._entries:
            self._entries[digest].last_used = now
            return False
        while len(self._entries) >= self.max_entries:
            if not self.evict_one():
                return False
        for p in pages:
            self.pool.retain(p)
        self._entries[digest] = _EncEntry(list(pages), enc_len, now)
        return True

    def evict_one(self) -> bool:
        """Drop the least-recently-used entry and its page references."""
        victim = None
        for d, e in self._entries.items():
            if victim is None or e.last_used < self._entries[victim].last_used:
                victim = d
        if victim is None:
            return False
        for p in self._entries.pop(victim).pages:
            self.pool.release(p)
        self.evictions += 1
        return True

    def clear(self) -> None:
        while self.evict_one():
            pass

    def held_pages(self) -> List[int]:
        return [p for e in self._entries.values() for p in e.pages]
