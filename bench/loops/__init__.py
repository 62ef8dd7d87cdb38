"""The loops that drive the batcher, one module a kind, found by the name a
mix file gives under `loop` (`bench.loops.<loop>`).  Each module has
`make(batcher, mix, vocab, seed, seconds, clock)`, which returns the loop:
`fill()`, `run_filled()`, `after`, `served`, `t_start`, `t_stop`,
`close_iter`, `in_window(it)`, `stats_between(a, b)` and `window_stats()`
(see `closed.py`)."""
