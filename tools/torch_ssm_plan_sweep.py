#!/usr/bin/env python3
"""Times `ssm_scan`'s kernels (src/repro_torch/csrc/ssm_scan.cu) on plans
other than the one `ssm_plan` picks, at the scan shapes `chip_smoke.py`
times (`SSM_PATH`), to choose the plan's rule on the card.

    python3 tools/torch_ssm_plan_sweep.py > ssm_sweep.log

Needs one NVIDIA Hopper GPU.  For each shape: every instantiated (rows,
entries) a thread pair that takes its N, each at the rule's time tile and
its own, then the rule's pair at every time tile, and where L spans four
chunks or more, other chunk lengths and none.  The shapes are
`SSM_PATH`'s, then zamba2's 4096-token prefill at batch 2 to 16
(`CHUNK_EDGE`), where the rule's bound on the state for chunking
(`CHUNKED_STATE`) falls.  Each plan's output is held against the
sequential oracle at `chip_smoke.py`'s tolerance (rtol = atol 2e-4) and
timed.  One JSON line per shape, then the card's name and power limit.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (raises without a card)
from repro_torch.kernels import ssm_scan as ss  # noqa: E402


# zamba2's 4096-token prefill at batch 2, 4, 8 and 16: BH * P * N from
# 2^19 to 2^22, around `ssm_scan.CHUNKED_STATE`
CHUNK_EDGE = [(f"zamba2 B={b} L=4096", 64 * b, 4096, 64, 64, ("bf16",) * 3, b)
              for b in (2, 4, 8, 16)]


def candidates(bh, g, l, p, n, dts) -> list:
    rule = ss.ssm_plan(bh, g, l, p, n, dts)
    asks = [dict(rt=rt, ns=ns, **extra) for (rt, ns) in ss.RING_VARIANTS
            for extra in (dict(t_tile=rule.t_tile), {})]
    asks += [dict(rt=rule.rt, ns=rule.ns, t_tile=t) for t in ss.T_TILES]
    if l >= 4 * ss.CHUNK:      # chunk-parallel or not, and other chunk lengths
        asks += [dict(chunk=0), dict(chunk=ss.CHUNK), dict(rt=1, ns=8, chunk=ss.CHUNK)]
        asks += [dict(rt=4, ns=16, chunk=ch, t_tile=t)
                 for ch in (64, 128, 256, 512) for t in (8, 16)]
    out = [rule]
    for kw in asks:
        try:
            plan = ss.ssm_plan(bh, g, l, p, n, dts, **kw)
        except ValueError:       # an N the pair does not take, or too much shared memory
            continue
        if plan not in out:
            out.append(plan)
    return out


def kernel_split(x, a, b, c, plan, calls: int = 5) -> list:
    """Device ms a call of each kernel a chunked plan launches (the passes
    and the carry), from `torch.profiler` over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile
    y = torch.empty(x.shape, dtype=torch.float32, device=cs.DEV)
    scratch = ss.chunk_scratch(x, b.shape[2], plan)
    ss.launch(x, a, b, c, y, plan, scratch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ss.launch(x, a, b, c, y, plan, scratch)
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if "ssm_scan_kernel" in e.key:
            out.append({"name": e.key[:80], "calls": e.count, "ms_a_call": us / 1e3 / calls})
    return out


def sweep_shape(gen, name, bh, l, p, n, dts, g) -> dict:
    x, a, b, c = cs._ssm_inputs(gen, bh, l, p, n, dts, groups=g)
    want = cs._ssm_want(x, a, b, c)
    rule = ss.ssm_plan(bh, g, l, p, n, dts)
    rows = []
    for plan in candidates(bh, g, l, p, n, dts):
        row = {**plan.as_dict(), "chosen": plan == rule}
        y = torch.empty((bh, l, p), dtype=torch.float32, device=cs.DEV)
        scratch = ss.chunk_scratch(x, n, plan)
        err = ss.launch(x, a, b, c, y, plan, scratch)
        torch.cuda.synchronize()
        if err:
            row["cuda_error"] = err
        else:
            diff = (y - want).abs()
            row["max_abs_err"] = float(diff.max())
            row["within_tolerance"] = bool((diff <= 2e-4 + 2e-4 * want.abs()).all())
            row["ms"] = cs.time_ms(lambda: ss.launch(x, a, b, c, y, plan, scratch))
        rows.append(row)
    ok = [r for r in rows if r.get("within_tolerance")]
    best = min(ok, key=lambda r: r["ms"], default=None)
    kernels = kernel_split(x, a, b, c, rule) if rule.chunks > 1 else None
    return {"shape": {"name": name, "bh": bh, "l": l, "p": p, "n": n, "groups": g},
            "plan": rule.as_dict(), "plan_ms": next((r["ms"] for r in ok if r["chosen"]), None),
            "best": best, "kernels_of_plan": kernels, **cs.ssm_bound_ms(x, a, b, c),
            "rows": rows}


def main() -> None:
    info = cs.phase_device()
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    for shape in cs.SSM_PATH + CHUNK_EDGE:
        cs.emit(sweep_shape(gen, *shape))
    print(info["nvidia_smi"], flush=True)


if __name__ == "__main__":
    main()
