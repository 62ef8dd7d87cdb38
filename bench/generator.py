"""The general traffic generator: the requests of one mix from its data file.

A mix file (`traffic/<mix>.json`) gives the loop that drives the batcher
(`loop`, a module of `bench.loops`), a lognormal (median, sigma, clipped to
[min, max]) for the prompt and the output lengths, and the block of the
script below; any further keys are the loop's own (`Mix.params`).  The
batcher's slots, `max_len` and prompt bucket are the deployment's, from
the configuration file (`serve`).  In the closed loop one client per slot
sends its requests one after another.

Every seed gets the same work.  The lengths form one script, the same for
every seed: blocks of `block` requests, each holding the block's
mid-quantiles of both distributions (prompt and output lengths each in an
order of the script's own, so the script also pairs them), dealt to the
clients in turn.  A client's first request, which fills its slot before
the window opens, asks for a residual output: a stratified share of its
drawn output length, so that completions are spread from the window's
first second.  The seed assigns the script's sequences to the clients
(which client serves which sequence) and draws the prompt token ids,
uniform in [1, vocab) (0 is the batcher's padding id).  The slots are
alike, so the seed changes which slot serves which request and every
token, and not when the batcher admits and finishes requests: a seed's
window holds the same iterations as another's, and the runs of a cell
differ by their timing alone.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from statistics import NormalDist
from typing import List

import numpy as np

# independent streams of one seed: the clients' sequences, token ids, the
# check's sample
CLIENTS, TOKENS, SAMPLE = 1, 2, 3
SCRIPT = 0       # the seed of the script of lengths, the same for every run


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of `seed` (any whole number)."""
    return np.random.default_rng([seed & (2 ** 64 - 1), stream])


@dataclass(frozen=True)
class Mix:
    name: str
    n_slots: int
    max_len: int
    prompt_bucket: int
    block: int
    prompt: dict
    output: dict
    loop: str = "closed"
    params: dict = field(default_factory=dict)

    @classmethod
    def load(cls, path: Path, serve: dict) -> "Mix":
        """The mix of `path` served by the deployment `serve` (`n_slots`,
        `max_len`, `prompt_bucket`)."""
        d = json.loads(Path(path).read_text())
        own = ("name", "loop", "block", "prompt", "output")
        mix = cls(name=d["name"], loop=d["loop"], block=d["block"], prompt=d["prompt"],
                  output=d["output"], params={k: v for k, v in d.items() if k not in own},
                  n_slots=serve["n_slots"], max_len=serve["max_len"],
                  prompt_bucket=serve["prompt_bucket"])
        longest = mix.prompt["max"] + mix.output["max"]
        if longest > mix.max_len + 1 or mix.bucket_of(mix.prompt["max"]) >= mix.max_len:
            raise ValueError(f"{path}: a request of {longest} tokens does not fit "
                             f"max_len {mix.max_len}")
        return mix

    def bucket_of(self, prompt_len: int) -> int:
        """The padded length the batcher prefills a prompt at (its last
        token is decoded, not prefilled)."""
        b = self.prompt_bucket
        return max(b, -(-(prompt_len - 1) // b) * b)

    def buckets(self) -> List[int]:
        """Every padded prefill length this mix's prompts can take."""
        lo, hi = self.prompt["min"], self.prompt["max"]
        return sorted({self.bucket_of(n) for n in range(lo, hi + 1)})


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n mid-quantiles of a clipped lognormal, as whole lengths."""
    if dist.get("dist") != "lognormal":
        raise ValueError(f"unknown length distribution {dist!r}")
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.rint(dist["median"] * np.exp(dist["sigma"] * z))
    return np.clip(x, dist["min"], dist["max"]).astype(np.int64)


@dataclass
class Draw:
    prompt: List[int]
    max_new: int


class Script:
    """The lengths of every client's requests, in order: (prompt, output)."""

    def __init__(self, mix: Mix):
        self.mix = mix
        self._g = rng(SCRIPT, 0)
        self._p = quantiles(mix.prompt, mix.block)
        self._o = quantiles(mix.output, mix.block)
        n = mix.n_slots
        self._share = (self._g.permutation(n) + 1) / n      # the first requests' shares
        self.seqs: List[List[tuple]] = [[] for _ in range(n)]
        self._dealt = 0

    def _deal_block(self) -> None:
        n = self.mix.n_slots
        for p, o in zip(self._g.permutation(self._p).tolist(),
                        self._g.permutation(self._o).tolist()):
            c, k = self._dealt % n, self._dealt // n
            if k == 0:
                o = max(1, math.ceil(self._share[c] * o))
            self.seqs[c].append((p, o))
            self._dealt += 1

    def get(self, seq: int, k: int) -> tuple:
        while len(self.seqs[seq]) <= k:
            self._deal_block()
        return self.seqs[seq][k]


class Stream:
    """The requests of one run: each client's next one on demand."""

    def __init__(self, mix: Mix, vocab: int, seed: int):
        self.mix, self.vocab = mix, vocab
        self.script = Script(mix)
        self.seq_of = rng(seed, CLIENTS).permutation(mix.n_slots).tolist()
        self._tok = rng(seed, TOKENS)
        self.sent = [0] * mix.n_slots

    def next(self, client: int) -> Draw:
        plen, olen = self.script.get(self.seq_of[client], self.sent[client])
        self.sent[client] += 1
        toks = self._tok.integers(1, self.vocab, size=plen).tolist()
        return Draw(prompt=toks, max_new=int(olen))
