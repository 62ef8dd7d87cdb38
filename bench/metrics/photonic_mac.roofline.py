"""photonic_mac.roofline: `mac_kernel_sm90`'s share of its roofline in the
traced span (`counts.bounds.mac_bound_s`: bf16 x, int8 levels, f32 bank
scales and f32 output, or 2MKN at the bf16 peak).  Moves out_tok_s."""

from bench.counts.bounds import mac_bound_s


def read(run):
    if run.span is None:
        return None
    return run.span.roofline("photonic_mac", "mac_kernel_sm90",
                             lambda m, k, n: mac_bound_s(m, k, n, 2))
