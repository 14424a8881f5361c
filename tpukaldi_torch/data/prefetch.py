"""Background chunk prefetching: load chunk N+1 on a host thread while the
device trains on chunk N (counterpart of tpukaldi's `data/prefetch.py`;
reference core.py:509-512 prefetch thread).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from .chunk_loader import ChunkData


class ChunkPrefetcher:
    """Single-slot double buffer: `start(fn)` kicks off a loader thread,
    `take()` joins and returns the result (re-raising loader errors)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._result: Optional[ChunkData] = None
        self._error: Optional[BaseException] = None
        # seconds the loader thread spent loading, even where they overlap
        # device work: a 0.0 `host_load` then still shows what was hidden
        self.producer_seconds: float = 0.0

    def start(self, loader: Callable[[], ChunkData]) -> None:
        if self._thread is not None:
            raise RuntimeError("prefetch already in flight; call take() first")
        self._result, self._error = None, None

        def run():
            t0 = time.perf_counter()
            try:
                self._result = loader()
            except BaseException as e:  # re-raised at take()
                self._error = e
            finally:
                self.producer_seconds += time.perf_counter() - t0

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="tpukaldi-chunk-prefetch")
        self._thread.start()

    def take(self) -> ChunkData:
        if self._thread is None:
            raise RuntimeError("no prefetch in flight")
        self._thread.join()
        self._thread = None
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def in_flight(self) -> bool:
        return self._thread is not None
