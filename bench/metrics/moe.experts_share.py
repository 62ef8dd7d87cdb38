"""moe.experts_share: the device time of the operations under the model's
`moe.experts` ranges, as a share of the device's busy time in the traced
span.  Nothing to read where the model has no experts.  Moves out_tok_s."""


def read(run):
    sp = run.span
    if sp is None or not sp.busy_s or "moe.experts" not in sp.ranges:
        return None
    return 100.0 * sp.ranges["moe.experts"] / sp.busy_s
