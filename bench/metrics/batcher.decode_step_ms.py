"""batcher.decode_step_ms: the batcher's own time per decode step over the
window (`ContinuousBatcher.stats`: host clock, each step ending in the
copy of its tokens to the host).  Moves tpot_p90_ms."""


def read(run):
    d = run.window_stats()
    return d["decode_s"] / d["decode_iters"] * 1e3 if d["decode_iters"] else None
