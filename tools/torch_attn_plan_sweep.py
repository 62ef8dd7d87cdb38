#!/usr/bin/env python3
"""Times `attn_kernel_sm90` (src/repro_torch/csrc/flash_attention.cu) on
plans other than the one `attn_plan` picks, at the prefill shapes
`chip_smoke.py` times (`ATTN_TIMED`), to choose the plan's rule on the card.

    python3 tools/torch_attn_plan_sweep.py > attn_sweep.log

Needs one NVIDIA Hopper GPU.  For each shape: both grid orders wherever the
causal mask gives the query tiles unequal work (more than one query tile).
Each plan's output is held
against the plain version at `chip_smoke.py`'s bf16 tolerance (rtol = atol
2e-2; at batch 128 the first 4 batch rows, as there) and timed, beside
`scaled_dot_product_attention` on the same inputs.  One JSON line per shape,
then the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (raises without a card)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def launch(q, k, v, window: int, plan: fa.AttnPlan):
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    return out, fa._launch_sm90(q, k, v, out, q.shape[-1] ** -0.5, True, window, 0, plan)


def sweep_shape(gen, model: str, b: int, s: int, hq: int, hk: int, d: int, window: int) -> dict:
    q, k, v = cs._attn_inputs(gen, b, hq, hk, s, s, d, torch.bfloat16, model_layout=True)
    rows_checked = min(b, 4)
    want = ref.attention_ref(q[:rows_checked], k[:rows_checked], v[:rows_checked], window=window)
    chosen = fa.attn_plan(b, hq, hk, s, s, d, True, window, 0)
    rows = []
    for heavy_first in ((True, False) if chosen.skip and chosen.q_tiles > 1 else (False,)):
        plan = dataclasses.replace(chosen, heavy_first=heavy_first)
        out, err = launch(q, k, v, window, plan)
        row = {**plan.as_dict(), "chosen": plan == chosen}
        if err:
            row["cuda_error"] = err
            torch.cuda.synchronize()
        else:
            diff = (out[:rows_checked] - want).abs()
            row["max_abs_err"] = float(diff.max())
            row["within_tolerance"] = bool((diff <= 2e-2 + 2e-2 * want.abs()).all())
            row["ms"] = cs.time_ms(lambda: launch(q, k, v, window, plan))
        rows.append(row)
        del out
    kr, vr = k.repeat_interleave(hq // hk, dim=1), v.repeat_interleave(hq // hk, dim=1)
    library_ms = cs.time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kr, vr, is_causal=True))
    ok = [r for r in rows if r.get("within_tolerance")]
    best = min(ok, key=lambda r: r["ms"], default=None)
    return {"model": model, "shape": {"b": b, "hq": hq, "hk": hk, "s": s, "d": d},
            "window": window, "plan": chosen.as_dict(),
            "plan_ms": next((r["ms"] for r in ok if r["chosen"]), None), "best": best,
            "library_ms": library_ms,
            **cs.attn_bound_ms(b, hq, hk, s, s, d, torch.bfloat16, True, window, 0),
            "rows": rows}


def main() -> None:
    info = cs.phase_device()
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    for shape in cs.ATTN_TIMED:
        cs.emit(sweep_shape(gen, *shape))
    print(info["nvidia_smi"], flush=True)


if __name__ == "__main__":
    main()
