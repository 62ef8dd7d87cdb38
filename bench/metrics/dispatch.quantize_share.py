"""dispatch.quantize_share: the device time of the operations under the
photonic linear's `photonic.quantize` ranges (the weight's bank maxima and
levels, not its product), as a share of the device's busy time in the
traced span.  Nothing to read where the program has no such range.
Moves out_tok_s."""


def read(run):
    sp = run.span
    if sp is None or not sp.busy_s or "photonic.quantize" not in sp.ranges:
        return None
    return 100.0 * sp.ranges["photonic.quantize"] / sp.busy_s
