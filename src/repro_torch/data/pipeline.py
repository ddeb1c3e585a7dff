"""Host data pipeline with background prefetch (port of
``repro/data/pipeline.py``).

Deterministic: the iterator's state is just the step; a restart at step N
regenerates the identical stream (used by ``ft.recovery``)."""
from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Dict


class DataPipeline:
    def __init__(self, gen: Callable[[int], Dict], start_step: int = 0,
                 prefetch: int = 2):
        self._gen = gen
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, self._gen(step), None)
            except Exception as e:        # surfaced to the consumer
                item = (step, None, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[2] is not None:
                return
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        step, batch, err = self._q.get()
        if err is not None:
            raise err
        self._step = step + 1
        return batch

    @property
    def step(self) -> int:
        return self._step

    def close(self):
        """Stop and join the prefetch thread."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            logging.getLogger("repro_torch.data").warning(
                "prefetch thread did not stop within 5s")
