"""Photonic-MAC kernel microbenchmark: QAT distortion across MR resolutions
(the 2.5D-CrossLight precision/energy trade-off) and, on the card, the time
of the `photonic_mac` kernel beside its plain version and `torch.matmul` on
the dequantised weights.

The PyTorch port's counterpart of `benchmarks/photonic_mac_bench.py`.  The
distortion is the relative Frobenius error of x @ quantize(w) against the
unquantised f32 product, at 512^3 for 8/6/4/2-bit banks, with x and w drawn
from numpy seeds; on ``--device`` cuda the product is the kernel's, on the
CPU its plain version's.  The times are taken only on the card (CUDA events
around a run of calls, the device kept busy while the host enqueues them),
each beside the card's name and power limit and the card's bound for the
same work; a CPU run writes none.  Writes `artifacts/torch_kernels.json`.

    PYTHONPATH=src python benchmarks/torch_kernels_bench.py [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.kernels import ref
from repro_torch.kernels.photonic_mac import dispatch, photonic_mac, quantize_weights
from repro_torch.kernels.timing import card, mac_bound_ms, time_ms

OUT = Path(__file__).resolve().parent / "artifacts" / "torch_kernels.json"

BITS = (8, 6, 4, 2)
SHAPE = (512, 512, 512)
# the timed products (M, K, N, activation dtype): the distortion's shape with
# f32 activations (the FMA kernel) and bf16 ones (the tensor-core kernel);
# the serving paths' shapes are timed by `chip_smoke.py`'s kernels phase
TIMED = [(512, 512, 512, "float32"), (512, 512, 512, "bfloat16")]


def inputs(m: int, k: int, n: int, seed: int = 0):
    """x (M,K) and w (K,N), standard normal f32, from numpy seeds."""
    x = np.random.default_rng(seed).standard_normal((m, k), dtype=np.float32)
    w = np.random.default_rng(seed + 1).standard_normal((k, n), dtype=np.float32)
    return x, w


def distortion(x: torch.Tensor, w: torch.Tensor, bits: int) -> float:
    """Relative Frobenius error of the photonic product at `bits` against
    the unquantised product."""
    wq, sc = quantize_weights(w, bits=bits)
    out = photonic_mac(x, wq, sc)
    exact = x @ w
    return float(torch.linalg.vector_norm(out - exact) / torch.linalg.vector_norm(exact))


def timed_rows(device: torch.device) -> list:
    rows = []
    for (m, k, n, dtype) in TIMED:
        xn, wn = inputs(m, k, n)
        x = torch.as_tensor(xn).to(device).to(getattr(torch, dtype))
        wq, sc = quantize_weights(torch.as_tensor(wn).to(device), bits=8)
        w_dq = ref.dequantize_ref(wq, sc).to(x.dtype)
        kernel, _ = dispatch(x, wq)
        rows.append({"shape": [m, k, n], "x": dtype, "bits": 8, "kernel": kernel,
                     "ms": time_ms(lambda: photonic_mac(x, wq, sc)),
                     "plain_ms": time_ms(lambda: ref.photonic_mac_ref(x, wq, sc)),
                     "library_ms": time_ms(lambda: torch.matmul(x, w_dq)),
                     **mac_bound_ms(m, k, n, x.dtype)})
        rows[-1]["tflops"] = 2.0 * m * k * n / rows[-1]["ms"] / 1e9
    return rows


def run(csv: bool = True, device="cuda") -> dict:
    device = require_device(device)
    m, k, n = SHAPE
    xn, wn = inputs(m, k, n)
    x, w = torch.as_tensor(xn).to(device), torch.as_tensor(wn).to(device)
    rows = [{"bits": bits, "rel_err": distortion(x, w, bits)} for bits in BITS]
    on_card = device.type == "cuda"
    out = {"shape": [m, k, n], "device": torch.cuda.get_device_name(device) if on_card else "cpu",
           "card": card() if on_card else None, "rows": rows,
           "timed": timed_rows(device) if on_card else "not measured (no card)"}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1))
    if csv:
        for r in rows:
            print(f"photonic_mac/{r['bits']}bit,rel_err={r['rel_err']:.4f}")
        if on_card:
            print(f"card,{out['card']}")
            for r in out["timed"]:
                print(f"photonic_mac/{'x'.join(map(str, r['shape']))}/{r['x']},"
                      f"{r['kernel']},ms={r['ms']:.5f};plain_ms={r['plain_ms']:.5f};"
                      f"library_ms={r['library_ms']:.5f};bound_ms={r['bound_ms']:.5f}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
