"""batcher.prefill_ms: the batcher's own prefill time per call over the
window (`ContinuousBatcher.stats`: host clock, the device synchronised
around each call and its copy into the slot).  Moves ttft_p90_ms."""


def read(run):
    d = run.window_stats()
    return d["prefill_s"] / d["prefill_calls"] * 1e3 if d["prefill_calls"] else None
