"""device.idle_share: the share of the traced span's host-clock seconds in
which no operation ran on the device.  Moves out_tok_s."""


def read(run):
    sp = run.span
    if sp is None or sp.window_s <= 0:
        return None
    return 100.0 * (1.0 - sp.busy_s / sp.window_s)
