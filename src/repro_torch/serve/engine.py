"""Continuous-batching serving engine (iteration-level scheduling).

A fixed pool of `n_slots` cache slots decodes in lockstep, but each slot sits
at its OWN position (`serve_step` takes a (B,) position vector); finished
requests free their slot, which is immediately refilled by prefilling the
next queued request into that slot's cache rows.  Prompts are right-padded to
a multiple of `prompt_bucket`, so prefill sees few distinct lengths.

Why it matters here: decode is memory-bound, so throughput comes from
batching; continuous batching keeps the batch full under ragged request
lengths (the paper's bandwidth-matching argument applied to serving: keep the
provisioned lanes busy).

Cache leaves are layer-stacked, (L, B, ...): slot `i` owns batch row `i`.
The pooled cache is updated in place.

With `fabric=` (a `core.fabric.Fabric` or a preset name) the batcher also
models the photonic fabric under each decode iteration's tensor-parallel
collectives: a channel plan and the modelled network seconds per iteration
(`net_stats`), replanned when `inject_fault` (or `run(fault_at_iter=,
fault_scenario=)`) degrades the fabric, and `FabricUnusableError` when
nothing survives.  The model changes no numerics: tokens are those of a
batcher without a fabric.

Encoder-decoder configs raise `ValueError` at construction: the reference's
batcher prefills from tokens alone and decodes with no encoder output, so it
cannot serve them (ROADMAP.md, Queue 3), and the port adds no encoder
batching the reference lacks.  M-RoPE configs decode with per-slot (3, B, 1)
positions, equal streams at each slot's index, as the reference's do.

What the batcher measures, always on:
  * `stats`: counts of decode steps, prefill calls and their tokens, and
    the seconds of each phase.  On a card the seconds are CUDA event pairs
    on the device's stream, one around each admission's prefill and slot
    write and one around each decode step up to its argmax, read once the
    step's tokens have reached the host: the phase's interval on the
    stream, which holds any stall on the host's launches and none of the
    queueing behind earlier work.  On the CPU they are host-clock
    intervals.  Nothing synchronises the card; the copy of each step's
    tokens to the host is the loop's only wait, and the iteration's
    seconds are in `stats` before its first token is appended.
  * each `Request`'s stamps, on the host's `time.perf_counter()` clock:
    `submitted` in `submit`, and `admitted` when its admission starts.  On
    a card that start is the device's: an event recorded as the admission
    begins, read with the step's timers as the host clock less the event's
    distance to the end of the step the host has just waited for.  So it
    marks when the stream reached the admission, past the earlier work
    queued on the card, not when the host enqueued it.  On the CPU it is
    the host clock at the start of `_admit`.
  * profiler ranges (`spans.span`, only while a profiler runs):
    `batcher.admit` around an admission, `batcher.decode` around a decode
    step and its copy to the host, `batcher.emit` around the loop that
    hands the tokens out and frees slots.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.fabric import degrade, get_fabric
from repro_torch.core.faults import FabricUnusableError, FaultScenario
from repro_torch.core.planner import plan_collective_channels
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.spans import span


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # `time.perf_counter()` stamps, set by the batcher (module docstring)
    submitted: Optional[float] = None
    admitted: Optional[float] = None


def _slot_update(cache_tree, slot_tree, slot: int, n_slots: int):
    """Write `slot_tree` (batch=1 cache) into slot `slot` of the pooled cache
    (batch=n_slots), in place.  Cache leaves are layer-stacked: (L, B*ratio,
    ...), batch on axis 1 (ratio > 1 for fused batch*heads leaves)."""
    if isinstance(cache_tree, dict):
        for key in cache_tree:
            _slot_update(cache_tree[key], slot_tree[key], slot, n_slots)
    elif isinstance(cache_tree, (list, tuple)):
        for pool, one in zip(cache_tree, slot_tree):
            _slot_update(pool, one, slot, n_slots)
    else:
        ratio = cache_tree.shape[1] // n_slots
        assert slot_tree.shape[1] == ratio, (cache_tree.shape, slot_tree.shape, n_slots)
        cache_tree[:, slot * ratio:(slot + 1) * ratio].copy_(slot_tree)
    return cache_tree


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, params, n_slots: int, max_len: int,
                 eos_id: Optional[int] = None, prompt_bucket: int = 16,
                 fabric=None, decode_window_s: float = 2e-3, device="cuda"):
        if cfg.encoder_layers:
            raise ValueError(
                f"{cfg.name}: ContinuousBatcher serves decoder-only configs; the reference's "
                "batcher passes no enc_embeds to prefill and no enc_out to serve_step "
                "(ROADMAP.md, Queue 3)")
        self.device = M.check_params_device(params, device)
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_len = n_slots, max_len
        self.eos_id = eos_id
        # recurrent states integrate every input token, so right-padding
        # would corrupt them: recurrent families prefill at exact length
        self.bucket = 1 if cfg.family in ("ssm", "hybrid") else prompt_bucket
        self.cache = M.init_cache(cfg, n_slots, max_len, device=self.device)
        self.pos = np.zeros(n_slots, np.int32)       # next write position
        self.last_tok = np.zeros(n_slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self._next_rid = 0
        # phase seconds: event pairs on the stream (a card) or the host
        # clock (the CPU); see the module docstring
        self.stats = {"decode_iters": 0, "decode_tokens": 0, "decode_s": 0.0,
                      "prefill_calls": 0, "prefill_tokens": 0, "prefill_s": 0.0}
        self._card = self.device.type == "cuda"       # time on the stream, not the host
        self._events: list = []                       # free timing events
        self._laps: list = []                         # (stats key, start, end) unread
        self._admits: list = []                       # (request, start event) unread

        # modeled photonic fabric under the per-iteration tensor-parallel
        # collectives (2 all-reduces of bf16 activations per layer, the
        # whole decode batch); replanned on injected faults
        self.fabric = None if fabric is None else get_fabric(fabric)
        self.decode_window_s = decode_window_s
        self.collective_channels = None
        self.net_stats = {"decode_iters": 0, "modeled_net_s": 0.0,
                          "fault_iter": None, "replans": 0}
        if self.fabric is not None:
            self._replan()

    # ---- fault-epoch hook --------------------------------------------
    def _iter_wire_bytes(self) -> float:
        return float(self.cfg.n_layers * 2 * self.n_slots
                     * self.cfg.d_model * 2)

    def _replan(self) -> None:
        if self.fabric.cross_pod_bw_bytes_per_s <= 0:
            raise FabricUnusableError(
                f"fabric {self.fabric.name!r} has no surviving bandwidth; "
                f"decode collectives cannot be scheduled")
        self.collective_channels = plan_collective_channels(
            self._iter_wire_bytes(), self.decode_window_s,
            fabric=self.fabric, min_chunk_bytes=1 << 10)
        self._net_s_per_iter = self.fabric.collective_s(
            self._iter_wire_bytes(),
            n_collectives=self.cfg.n_layers * 2)
        self.net_stats["replans"] += 1

    def inject_fault(self, scenario: FaultScenario) -> None:
        """Degrade the serving fabric and replan — decode continues at the
        (modeled) reduced throughput, or hard-fails when nothing survives.
        The degraded design's energy is evaluated on the batcher's device."""
        if self.fabric is None:
            raise ValueError("batcher has no fabric to degrade")
        self.fabric = degrade(self.fabric, scenario, device=self.device)
        self._replan()
        self.net_stats["fault_iter"] = self.net_stats["decode_iters"]

    # ---- phase timers ------------------------------------------------
    def _mark(self):
        """Now: an event recorded on the device's current stream (a card),
        else the host clock."""
        if not self._card:
            return time.perf_counter()
        ev = self._events.pop() if self._events else torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _lap(self, key: str, start):
        """Charge the time since `start` (a `_mark`) to `stats[key]`: at once
        on the host clock, at the next `_settle` on a card, where the end
        event is returned."""
        if not self._card:
            self.stats[key] += time.perf_counter() - start
            return None
        end = self._mark()
        self._laps.append((key, start, end))
        return end

    def _settle(self, now: float, end) -> None:
        """Read the pending events into `stats` and the admissions' stamps,
        and return them to the pool.  Called after a wait for the stream
        (the decode step's copy to the host): `now` is the host clock past
        `end`, which every pending event precedes."""
        for req, a in self._admits:
            req.admitted = now - a.elapsed_time(end) / 1e3
            self._events.append(a)
        self._admits.clear()
        for key, a, b in self._laps:
            self.stats[key] += a.elapsed_time(b) / 1e3
            self._events += (a, b)
        self._laps.clear()

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int) -> Request:
        r = Request(self._next_rid, list(prompt), max_new, submitted=time.perf_counter())
        self._next_rid += 1
        self.queue.append(r)
        return r

    # ------------------------------------------------------------------
    def _admit(self, slot: int, req: Request):
        """Prefill prompt[:-1] into the slot, then seed decode with the last
        prompt token at pos len-1: the first decode step processes that token
        fresh and yields the first generated token.  Right-pad KV beyond the
        real length is position-masked and overwritten as decode advances."""
        with span("batcher.admit"):
            start = self._mark()
            if self._card:
                self._admits.append((req, start))
            else:
                req.admitted = start
            core = req.prompt[:-1]
            if not core:
                # empty prefill: reset the slot to the zero cache
                fresh = M.init_cache(self.cfg, 1, self.max_len, device=self.device)
                _slot_update(self.cache, fresh, slot, self.n_slots)
            else:
                plen = max(self.bucket,
                           ((len(core) + self.bucket - 1) // self.bucket) * self.bucket)
                if plen >= self.max_len:
                    raise ValueError(f"request {req.rid}: padded prompt length {plen} does "
                                     f"not fit max_len={self.max_len}")
                toks = np.zeros((1, plen), np.int64)
                toks[0, :len(core)] = core
                t0 = self._mark()
                _, slot_cache = M.prefill(self.cfg, self.params, {"tokens": toks},
                                          cache_len=self.max_len, device=self.device)
                _slot_update(self.cache, slot_cache, slot, self.n_slots)
                self._lap("prefill_s", t0)
                self.stats["prefill_calls"] += 1
                self.stats["prefill_tokens"] += plen
            self.slot_req[slot] = req
            self.pos[slot] = len(req.prompt) - 1
            self.last_tok[slot] = req.prompt[-1]

    # ------------------------------------------------------------------
    def run(self, fault_at_iter: Optional[int] = None,
            fault_scenario: Optional[FaultScenario] = None) -> List[Request]:
        """Drain the queue; returns all finished requests.  With
        `fault_at_iter`, `fault_scenario` is injected before that decode
        iteration (0-based) — the modeled network time per iteration rises
        and `net_stats` records the fault point."""
        finished: List[Request] = []
        while self.queue or any(r is not None for r in self.slot_req):
            if (fault_at_iter is not None
                    and self.net_stats["decode_iters"] == fault_at_iter
                    and self.net_stats["fault_iter"] is None):
                self.inject_fault(fault_scenario)
            # admit into free slots
            for s in range(self.n_slots):
                if self.slot_req[s] is None and self.queue:
                    self._admit(s, self.queue.pop(0))
            # lockstep decode at per-slot positions
            with span("batcher.decode"):
                t0 = self._mark()
                logits, self.cache = M.serve_step(
                    self.cfg, self.params, self.cache, self.last_tok[:, None],
                    self.pos, device=self.device)
                nxt = torch.argmax(logits[:, -1], dim=-1)
                t1 = self._lap("decode_s", t0)
                nxt = nxt.cpu().numpy()       # the loop's one wait for the device
            self._settle(time.perf_counter(), t1)
            self.stats["decode_iters"] += 1
            self.stats["decode_tokens"] += sum(r is not None for r in self.slot_req)
            self.net_stats["decode_iters"] += 1
            if self.fabric is not None:
                self.net_stats["modeled_net_s"] += self._net_s_per_iter
            with span("batcher.emit"):
                for s in range(self.n_slots):
                    req = self.slot_req[s]
                    if req is None:
                        continue
                    tok = int(nxt[s])
                    req.out.append(tok)
                    self.pos[s] += 1
                    self.last_tok[s] = tok
                    hit_eos = self.eos_id is not None and tok == self.eos_id
                    if (len(req.out) >= req.max_new or hit_eos
                            or self.pos[s] >= self.max_len - 1):
                        req.done = True
                        finished.append(req)
                        self.slot_req[s] = None
        return finished
