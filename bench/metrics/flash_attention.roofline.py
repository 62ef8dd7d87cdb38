"""flash_attention.roofline: `attn_kernel_sm90`'s share of its roofline in
the traced span (`counts.bounds.attn_bound_s`: bf16 q, k, v and f32 output,
or 4d operations a kept pair and head at the bf16 peak).  Prefills only: a
decode step attends by plain tensor code.  Moves ttft_p90_ms."""

from bench.counts.bounds import attn_bound_s


def read(run):
    if run.span is None:
        return None
    return run.span.roofline("flash_attention", "attn_kernel_sm90",
                             lambda *s: attn_bound_s(*s, esize=2))
