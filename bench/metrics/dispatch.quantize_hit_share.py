"""dispatch.quantize_hit_share: the share of the photonic linear's banked
calls that took a weight's kept int8 levels instead of quantising it
(`photonic_matmul.quant_hits` over hits and `.quant_misses`, the program's
own counters, over the whole process: set-up's first wave fills the
levels, later calls find them while the weights are unchanged).  Nothing
to read where the program has no such counters or made no such call.
Moves out_tok_s."""


def read(run):
    from repro_torch.kernels import ops

    hits = getattr(ops.photonic_matmul, "quant_hits", None)
    misses = getattr(ops.photonic_matmul, "quant_misses", None)
    if hits is None or misses is None or not hits + misses:
        return None
    return 100.0 * hits / (hits + misses)
