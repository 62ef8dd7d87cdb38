"""Asynchronous checkpointing: snapshot to the host synchronously (one copy
of every leaf to CPU memory), then write + fsync + rename in a background
thread so the train loop never blocks on disk.  Same on-disk format and
atomicity guarantees as `store.save`; `store.restore` reads both.
"""

from __future__ import annotations

import concurrent.futures as _fut
import threading
from pathlib import Path
from typing import Any, Optional

from repro_torch import tree as T
from repro_torch.checkpoint import store


class AsyncCheckpointer:
    """One background writer; `save()` returns immediately after the host
    snapshot.  A second save while a write is in flight blocks until the
    previous write lands (ordering guarantee: checkpoints commit in step
    order)."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._pool = _fut.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._pending: Optional[_fut.Future] = None
        self._lock = threading.Lock()

    def save(self, step: int, tree: Any) -> _fut.Future:
        # synchronous host snapshot: the state can be reused or changed in
        # place the moment this returns
        host_tree = T.map_structure(lambda x: x.detach().to("cpu", copy=True), tree)
        with self._lock:
            if self._pending is not None:
                self._pending.result()   # commit order
            self._pending = self._pool.submit(store.save, self.directory, step, host_tree,
                                              self.keep)
            return self._pending

    def wait(self):
        with self._lock:
            if self._pending is not None:
                self._pending.result()
                self._pending = None

    def close(self):
        self.wait()
        self._pool.shutdown(wait=True)
