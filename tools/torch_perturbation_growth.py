"""How far zamba2, at random initialisation, amplifies a small perturbation
through its depth: the reason `chip_smoke.py` holds zamba2's and xlstm's
kernels-on vs kernels-off logits in f32 rather than bf16.

    PYTHONPATH=src python tools/torch_perturbation_growth.py [--layers 2 7 13]

Runs on the CPU at zamba2's full width with the depth cut to `--layers`
(seconds per depth).  For each depth and compute dtype it prints the largest
difference of the final hidden states, relative to their largest value,
between
  * the plain versions of the kernels (sequential scan in f32) and the
    reference's `use_kernels=False` path (chunked scan, which rounds to the
    compute dtype inside), and
  * the same plain-kernel run with the embeddings scaled by 1 + 1e-3 noise,
and, per scan call of the bf16 run, how far the chunked scan is from the
sequential one.  Numerics only: no time is measured.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs as C
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 7, 13])
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()
    for n_layers in args.layers:
        base = dataclasses.replace(C.get("zamba2_1p2b"), n_layers=n_layers)
        params = M.init(base, seed=0, device="cpu")
        toks = torch.randint(2, base.vocab, (1, args.seq),
                             generator=torch.Generator().manual_seed(2))
        emb = params["embed"]
        noisy = emb * (1 + 1e-3 * torch.randn(emb.shape, generator=torch.Generator().manual_seed(5)))

        def hidden(cfg, embed=emb):
            params["embed"] = embed
            h, _ = M.forward_hidden(cfg, params, {"tokens": toks}, device="cpu")
            params["embed"] = emb
            return h.float()

        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(base, dtype=dtype)
            calls = []
            impl = ops._ssm_impl
            ops._ssm_impl = lambda x, a, b, c, k: calls.append((x, a, b, c)) or impl(x, a, b, c, k)
            try:
                on = hidden(dataclasses.replace(cfg, use_kernels=True))
            finally:
                ops._ssm_impl = impl
            off = hidden(dataclasses.replace(cfg, use_kernels=False))
            pert = hidden(dataclasses.replace(cfg, use_kernels=True), noisy)
            per_call = [_rel(ref.ssm_scan_chunked_ref(*t), ref.ssm_scan_ref(*t)) for t in calls]
            print(f"layers {n_layers:3d} {dtype:8s}  plain kernels vs use_kernels=False: "
                  f"{_rel(on, off):.3g}   vs 1e-3 embedding noise: {_rel(pert, on):.3g}   "
                  f"chunked vs sequential scan per call: {min(per_call):.2g}-{max(per_call):.2g}",
                  flush=True)


if __name__ == "__main__":
    main()
