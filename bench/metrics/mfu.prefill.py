"""mfu.prefill: the model FLOPs of the window's prefills (real prompt
tokens) over the batcher's prefill seconds in the window times the card's
bf16 peak: the prefill step's share of the peak, which bounds
flash_attention.roofline's gains.  Moves ttft_p90_ms."""

from bench.counts import peaks


def read(run):
    s = run.window_stats()["prefill_s"]
    if s <= 0:
        return None
    return 100.0 * run.window_flops()["prefill"] / (s * peaks.BF16_FLOPS)
