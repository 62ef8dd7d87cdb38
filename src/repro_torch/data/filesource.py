"""Memory-mapped binary token corpus source (production data path).

A corpus is a flat little-endian uint16/uint32 token file (the standard
"packed tokens" format).  Sampling is deterministic in (step, host): every
host computes its disjoint slice of the global batch from the step index
alone — the same step-indexed determinism contract as `SyntheticLM`, so
checkpoint-resume replays identical batches and straggler/failure handling
composes unchanged.

Sequences are drawn strided across the corpus with a per-step deterministic
offset (golden-ratio hop) so consecutive steps cover the corpus without
shuffling state to checkpoint.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from repro_torch.data.pipeline import DataConfig


@dataclasses.dataclass
class TokenFileSource:
    cfg: object                    # ModelConfig (vocab clamp)
    data: DataConfig
    path: str | Path
    dtype: str = "uint16"
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        self._tokens = np.memmap(self.path, dtype=self.dtype, mode="r")
        need = self.data.seq_len + 1
        self._n_starts = max(1, len(self._tokens) - need)
        assert self.data.global_batch % self.host_count == 0
        self._local_b = self.data.global_batch // self.host_count

    def __len__(self):
        return len(self._tokens)

    def batch_at(self, step: int):
        """Deterministic (step, host)-indexed batch: {tokens, labels}."""
        need = self.data.seq_len + 1
        # golden-ratio hop gives full-period coverage of start offsets
        base = (step * 2654435761) % self._n_starts
        rows = []
        for i in range(self._local_b):
            g = self.host_index * self._local_b + i
            start = (base + g * (self._n_starts // max(
                self.data.global_batch, 1) + 1)) % self._n_starts
            rows.append(np.asarray(self._tokens[start:start + need],
                                   dtype=np.int32))
        arr = np.stack(rows)
        arr = np.minimum(arr, self.cfg.vocab - 1)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
