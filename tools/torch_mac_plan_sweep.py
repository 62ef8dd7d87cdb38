#!/usr/bin/env python3
"""Times `mac_kernel_sm90` (src/repro_torch/csrc/photonic_mac.cu) on plans
other than the one `mac_plan` picks, at the serving shapes `chip_smoke.py`
times (`MAC_TIMED`), to choose the plan's rule on the card.

    python3 tools/torch_mac_plan_sweep.py > plan_sweep.log

Needs one NVIDIA Hopper GPU.  For each shape: every row tile (128, 64, 32)
with every split of K into 1, 2, 4, 8 or 16 bank-aligned ranges (as far as K
has banks), each split summed both by a cluster of that many blocks and by
each block in turn, in both grid orders wherever there is more than one
row tile (with one, the two orders launch the same blocks in the same
order).  Each plan's output is held against the plain version
at `chip_smoke.py`'s bf16 tolerance (rtol 2e-2, atol 2e-1) and timed; a
launch the card refuses is recorded with its CUDA error.  One JSON line per
shape, then the card's name and power limit.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (raises without a card)
from repro_torch.kernels import photonic_mac as pm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def launch(x, w_q, sc, plan: pm.MacPlan):
    out = torch.empty((x.shape[0], w_q.shape[1]), dtype=torch.float32, device=x.device)
    return out, pm._launch_sm90(x, w_q, sc, out, plan)


def sweep_shape(gen, model: str, m: int, k: int, n: int) -> dict:
    x, w_q, sc = cs._mac_inputs(gen, m, k, n, torch.bfloat16, 8)
    want = ref.photonic_mac_ref(x, w_q, sc)
    chosen = pm.mac_plan(m, k, n)
    rows = []
    for bm in (128, 64, 32):
        for splits in (1, 2, 4, 8, 16):
            if splits > k // pm.BANK:
                continue
            m_tiles = -(-m // bm)
            for cluster, m_fast in [(c, f) for c in sorted({splits, 1}, reverse=True)
                                    for f in ((True, False) if m_tiles > 1 else (True,))]:
                plan = pm.MacPlan(bm=bm, splits=splits, cluster=cluster, m_tiles=m_tiles,
                                  n_tiles=n // pm.BANK, m_fast=m_fast)
                out, err = launch(x, w_q, sc, plan)
                row = {**plan.as_dict(), "chosen": plan == chosen}
                if err:
                    row["cuda_error"] = err
                    torch.cuda.synchronize()
                else:
                    diff = (out - want).abs()
                    row["max_abs_err"] = float(diff.max())
                    row["within_tolerance"] = bool((diff <= 2e-1 + 2e-2 * want.abs()).all())
                    row["ms"] = cs.time_ms(lambda: launch(x, w_q, sc, plan))
                rows.append(row)
                del out
    del want
    ok = [r for r in rows if r.get("within_tolerance")]
    best = min(ok, key=lambda r: r["ms"], default=None)
    return {"model": model, "shape": [m, k, n], "plan": chosen.as_dict(),
            "plan_ms": next((r["ms"] for r in ok if r["chosen"]), None),
            "best": best, **cs.mac_bound_ms(m, k, n, torch.bfloat16), "rows": rows}


def main() -> None:
    info = cs.phase_device()
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    for (model, m, k, n) in cs.MAC_TIMED:
        cs.emit(sweep_shape(gen, model, m, k, n))
    print(info["nvidia_smi"], flush=True)


if __name__ == "__main__":
    main()
