"""Deterministic synthetic data pipeline with prefetch and straggler hooks.
The reference's (`repro/data/pipeline.py`), numpy only; this package keeps
its own copy so as not to import the reference.  Batches are numpy arrays,
and the trainer moves them to its device.

  * `SyntheticLM` — seeded, step-indexed token streams (same step -> same
    batch, independent of restart point: checkpoint/resume reproducibility).
  * `Prefetcher` — background-thread double buffering (host-side overlap of
    data with compute: the host-to-device transfer window).
  * `DeadlineMonitor` — straggler mitigation: batches that miss the step
    deadline are dropped and accounted (the synchronous-SGD batch-drop
    strategy); the trainer reports its statistics with each run.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0


class SyntheticLM:
    """Zipf-ish synthetic token stream: step-indexed, host-shardable."""

    def __init__(self, cfg: ModelConfig, data: DataConfig,
                 host_index: int = 0, host_count: int = 1):
        assert data.global_batch % host_count == 0
        self.cfg, self.data = cfg, data
        self.host_index, self.host_count = host_index, host_count
        self.per_host = data.global_batch // host_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.data.seed * 1_000_003 + step) * 97 + self.host_index)
        b, s, v = self.per_host, self.data.seq_len, self.cfg.vocab
        # Zipf-like marginal over a permuted vocab; documents of random length
        ranks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        toks = (ranks % (v - 2)) + 2
        toks = toks.astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.mrope:
            pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None, None],
                                  (3, b, s)).copy()
            batch["positions"] = pos
        if self.cfg.frontend == "vision":
            rngf = np.random.default_rng(step + 7)
            batch["pixel_embeds"] = rngf.standard_normal(
                (b, min(256, s), self.cfg.d_model), dtype=np.float32)
        if self.cfg.encoder_layers:
            rngf = np.random.default_rng(step + 13)
            batch["enc_embeds"] = rngf.standard_normal(
                (b, max(1, s // 4), self.cfg.d_model), dtype=np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (double buffering)."""

    def __init__(self, source: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._src = source
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for item in self._src:
            if self._stop.is_set():
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass


@dataclasses.dataclass
class StragglerStats:
    steps: int = 0
    dropped: int = 0
    deadline_s: float = 0.0

    @property
    def drop_rate(self) -> float:
        return self.dropped / max(1, self.steps)


class DeadlineMonitor:
    """Synchronous-SGD straggler mitigation by deadline: a host that cannot
    deliver its shard by `deadline_s` has its microbatch dropped for that step
    (gradient renormalized by the survivor count).  On this CPU container the
    delivery time is simulated by the caller; the policy + accounting is the
    deliverable."""

    def __init__(self, deadline_s: float):
        self.stats = StragglerStats(deadline_s=deadline_s)

    def admit(self, delivery_s: float) -> bool:
        self.stats.steps += 1
        if delivery_s > self.stats.deadline_s:
            self.stats.dropped += 1
            return False
        return True

    def survivor_scale(self, n_hosts: int, n_dropped: int) -> float:
        """Gradient rescale so the expectation stays unbiased."""
        alive = max(1, n_hosts - n_dropped)
        return n_hosts / alive
