"""Host-side detokenization, off the tick loop (port of
``repro/serve/detok.py``, which is pure Python; the port keeps its own
copy, and its bytes equal the reference's for the same ids).

The engine tick must never block on string work: per-token text assembly
is pure Python and can cost more than a warm decode tick's host share. The
serving front end therefore routes every emitted token through a BACKLOG
drained by one dedicated worker thread:

    engine tick (on_token) --> DetokenizeWorker.backlog --> codec -->
        emit(stream_id, event)   [worker thread]

* ``PieceCodec``: token ids -> text pieces. The models serve synthetic
  token streams, so there is no learned vocabulary; the codec maps ids
  through a caller-supplied piece table or a deterministic synthetic one
  (sentencepiece-flavoured: pieces carry a leading ``▁`` word marker that
  renders as a space everywhere but at stream start). It is stateful per
  stream: the first piece of a stream strips its leading space.
* ``DetokenizeWorker``: the backlog thread. ``close()`` enqueues a
  sentinel BEHIND everything already in the backlog and joins, so every
  token emitted before shutdown is still detokenized and delivered: a
  server closing mid-stream flushes partial text instead of dropping it.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional, Sequence

WORD_MARK = "▁"  # ▁ sentencepiece-style leading-space marker


class PieceCodec:
    """Token ids -> text pieces, with per-stream leading-space state.

    ``pieces[tid]`` supplies the piece table; ids outside the table (or
    with no table) fall back to the deterministic synthetic piece
    ``▁t<tid>`` so every id detokenizes to SOMETHING reproducible —
    serving must not crash on a vocabulary-edge token.
    """

    def __init__(self, pieces: Optional[Sequence[str]] = None):
        self.pieces = list(pieces) if pieces is not None else None

    def piece(self, tid: int) -> str:
        if self.pieces is not None and 0 <= tid < len(self.pieces):
            return self.pieces[tid]
        return f"{WORD_MARK}t{tid}"

    def new_stream(self) -> "StreamDetok":
        return StreamDetok(self)


class StreamDetok:
    """One stream's incremental decoder: feed token ids, get text deltas.

    The concatenation of every returned delta is byte-identical to
    ``decode_all`` over the same ids — chunking never changes the bytes,
    which is the property the SSE parity tests hold.
    """

    def __init__(self, codec: PieceCodec):
        self.codec = codec
        self._at_start = True
        self.text = ""          # everything decoded so far

    def feed(self, tid: int) -> str:
        piece = self.codec.piece(tid)
        if piece.startswith(WORD_MARK):
            piece = ("" if self._at_start else " ") + piece[len(WORD_MARK):]
        self._at_start = False
        self.text += piece
        return piece


def decode_all(codec: PieceCodec, ids: Sequence[int]) -> str:
    """Whole-sequence reference decoding (the non-streaming path)."""
    s = codec.new_stream()
    for t in ids:
        s.feed(int(t))
    return s.text


_SENTINEL = object()


class DetokenizeWorker:
    """The detokenize backlog thread.

    ``push(stream_id, token, final)`` is called from the engine tick
    thread (cheap: one queue put). The worker owns the per-stream codec
    state and calls ``emit(stream_id, event)`` — from the WORKER thread —
    with event dicts shaped for the SSE layer:

        {"token": int, "text": str, "index": int}            per token
        {"done": True, "finish_reason": str, "text": str,
         "n_tokens": int}                                    per finish

    ``close()`` drains before joining: the sentinel enqueues behind every
    pending token, so partial text reaches its stream even when the
    server shuts down mid-flight. Idempotent.
    """

    def __init__(self, emit: Callable[[object, dict], None],
                 codec: Optional[PieceCodec] = None):
        self.codec = codec or PieceCodec()
        self.emit = emit
        self.backlog: "queue.Queue[object]" = queue.Queue()
        self._streams: Dict[object, StreamDetok] = {}
        self._counts: Dict[object, int] = {}
        # high-water mark of the backlog, tracked at push (the producer
        # side): the worst tick-thread-to-text lag the process has seen —
        # the telemetry gauge reads it alongside the live ``depth``
        self.peak_depth = 0
        self._thread = threading.Thread(
            target=self._run, name="detokenize-backlog", daemon=True)
        self._closed = False
        self._thread.start()

    # ---- producer side (engine tick thread) ---------------------------
    def push(self, stream_id, token: int):
        self.backlog.put((stream_id, int(token)))
        d = self.backlog.qsize()
        if d > self.peak_depth:
            self.peak_depth = d

    def finish(self, stream_id, reason: str):
        self.backlog.put((stream_id, _SENTINEL, reason))

    @property
    def depth(self) -> int:
        return self.backlog.qsize()

    # ---- worker side --------------------------------------------------
    def _run(self):
        while True:
            item = self.backlog.get()
            if item is _SENTINEL:
                return
            if len(item) == 3:                       # stream finished
                sid, _, reason = item
                s = self._streams.pop(sid, None)
                n = self._counts.pop(sid, 0)
                self.emit(sid, {
                    "done": True, "finish_reason": reason,
                    "text": s.text if s is not None else "",
                    "n_tokens": n,
                })
                continue
            sid, tok = item
            s = self._streams.get(sid)
            if s is None:
                s = self._streams[sid] = self.codec.new_stream()
                self._counts[sid] = 0
            delta = s.feed(tok)
            idx = self._counts[sid]
            self._counts[sid] = idx + 1
            self.emit(sid, {"token": tok, "text": delta, "index": idx})

    def close(self, timeout: float = 10.0):
        """Flush the backlog, then stop and join the worker thread."""
        if self._closed:
            return
        self._closed = True
        self.backlog.put(_SENTINEL)
        self._thread.join(timeout)
        if self._thread.is_alive():                  # pragma: no cover
            raise RuntimeError(
                "detokenize worker failed to drain within "
                f"{timeout}s ({self.backlog.qsize()} backlogged)")

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()
