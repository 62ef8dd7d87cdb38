"""attention.decode_share: the device time of the operations under the
model's `attention.decode` ranges (a decode step's attention over the
cache, not its cache writes), as a share of the device's busy time in the
traced span.  Nothing to read where the program has no such range.
Moves tpot_p90_ms."""


def read(run):
    sp = run.span
    if sp is None or not sp.busy_s or "attention.decode" not in sp.ranges:
        return None
    return 100.0 * sp.ranges["attention.decode"] / sp.busy_s
