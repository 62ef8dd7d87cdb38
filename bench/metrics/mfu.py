"""mfu: the model FLOPs of the window's work (every real prompt token and
every decoded token; `counts.<family>`) over the window's seconds times
the card's bf16 peak.  Moves out_tok_s."""

from bench.counts import peaks


def read(run):
    f = run.window_flops()
    return 100.0 * (f["prefill"] + f["decode"]) / (run.window_s * peaks.BF16_FLOPS)
