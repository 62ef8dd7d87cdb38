"""The closed loop around `ContinuousBatcher.run`: one client per slot.

The batcher offers no per-request hook, so each submitted `Request` gets a
`Stamped` list as its `out`.  The batcher appends each token after the
decode step's copy to the host, so `Stamped.append` stamps the host clock
after the device's work.  On a client's last token it submits that
client's next request, which the batcher admits at the next iteration: the
batcher never starves and never queues more than one iteration.

Iterations are told apart by `stats["decode_iters"]`, which the batcher
counts before it appends an iteration's tokens.  The window opens with the
last token of the first iteration (whose admissions are the first wave,
set-up that the traffic needs) and closes with the last token of the first
iteration to end past `seconds`.  At the first token of the iteration
after it, before that token is appended, `StopWindow` stops the run, or,
with `after`, at the first token of the first iteration for which
`after(it)` says so (a traced span follows the window so).  `after` is
called at the first token of every iteration past the window, the device
just synchronised by the copy to the host.  Nothing drains; every slot's
state is then that of the last iteration's end (its decode step has
written its cache rows, which the step repeats alike).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from bench.generator import Mix, Stream


class StopWindow(Exception):
    """Raised from a token's append when the window has closed."""


@dataclass
class Served:
    """One request as the loop saw it."""
    client: int
    prompt: List[int]
    max_new: int
    submitted: float
    submit_iter: int                 # the iteration whose tokens submitted it
    request: object = None
    stamps: List[float] = field(default_factory=list)
    iters: List[int] = field(default_factory=list)

    @property
    def tokens(self) -> List[int]:
        return list(self.request.out)

    @property
    def finished(self) -> bool:
        return len(self.stamps) >= self.max_new


class Stamped(list):
    """A request's `out`: each append stamped, the last one submitting the
    client's next request."""

    def __init__(self, loop: "ClosedLoop", served: Served):
        super().__init__()
        self.loop, self.served = loop, served

    def append(self, tok) -> None:
        now = self.loop.tick()
        super().append(tok)
        s = self.served
        s.stamps.append(now)
        s.iters.append(self.loop.iteration)
        if len(s.stamps) == s.max_new:
            self.loop.submit(s.client, now)


class ClosedLoop:
    def __init__(self, batcher, stream: Stream, seconds: float,
                 after: Optional[Callable[[int], bool]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.batcher, self.stream, self.seconds = batcher, stream, seconds
        self.after = after
        self.clock = clock
        self.served: List[Served] = []
        self.iteration = 0
        self.last_stamp = None
        self.t_start = self.t_stop = None
        self.stats_at = {}            # iteration -> batcher.stats at its first token
        self.close_iter = None        # the last iteration of the window

    def submit(self, client: int, now: float) -> Served:
        d = self.stream.next(client)
        s = Served(client=client, prompt=d.prompt, max_new=d.max_new, submitted=now,
                   submit_iter=self.iteration)
        r = self.batcher.submit(d.prompt, d.max_new)
        r.out = Stamped(self, s)
        s.request = r
        self.served.append(s)
        return s

    def fill(self) -> None:
        """The first wave: one request per slot, submitted before `run`."""
        now = self.clock()
        for c in range(self.batcher.n_slots):
            self.submit(c, now)

    def tick(self) -> float:
        """The clock at a token; at an iteration's first token, open or
        close the window, and stop the run (raising `StopWindow`)."""
        now = self.clock()
        it = self.batcher.stats["decode_iters"]
        if it != self.iteration:
            if self.t_start is None and it == 2:
                self.t_start = self.last_stamp
            elif (self.close_iter is None and self.t_start is not None
                  and self.last_stamp >= self.t_start + self.seconds):
                self.t_stop, self.close_iter = self.last_stamp, self.iteration
            if self.close_iter is not None and (self.after is None or self.after(it)):
                raise StopWindow
            self.iteration = it
            self.stats_at[it] = dict(self.batcher.stats)
        self.last_stamp = now
        return now

    def run(self) -> None:
        """Fill the slots and serve until the run stops."""
        self.fill()
        self.run_filled()

    def run_filled(self) -> None:
        """Serve the submitted first wave and its successors until the run
        stops."""
        try:
            self.batcher.run()
        except StopWindow:
            return
        raise RuntimeError("the batcher drained its queue: the closed loop broke")

    def stats_between(self, first: int, last: int) -> dict:
        """The change in the batcher's `stats` over iterations first + 1 ..
        last (each iteration's admissions and decode step)."""
        a, b = self.stats_at[first], self.stats_at[last]
        return {k: b[k] - a[k] for k in a}

    def window_stats(self) -> dict:
        """The change over the window's iterations (2 .. the closing one)."""
        return self.stats_between(1, self.close_iter)

    def in_window(self, it: int) -> bool:
        return 2 <= it <= self.close_iter


def make(batcher, mix: Mix, vocab: int, seed: int, seconds: float,
         clock: Callable[[], float] = time.perf_counter) -> ClosedLoop:
    """The closed loop of `mix` for one run of `seed`."""
    return ClosedLoop(batcher, Stream(mix, vocab, seed), seconds, clock=clock)
