"""The port's five model examples and its kernel bench on the CPU.

Each runs as a script in its own process with REPRO_SMOKE=1 and
``--device cpu`` and is checked as the reference's smoke tests check the
reference's examples (`tests/test_benchmarks_smoke.py`).  The numbers the
bench and the ablation print are held against the JAX package: the same
numpy weight quantized by `repro.kernels.photonic_mac.quantize_weights` and
dequantized by `repro.kernels.ref.dequantize_ref` gives the same relative
error at every bit width: rtol 1e-5 for the ablation's (both sides
quantize to the same levels and differ only in the order of the f32 sums
of the norms), 1e-4 for the bench's distortion (the port multiplies in
f32, the check in f64).
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.photonic_mac import quantize_weights as j_quantize

ROOT = Path(__file__).resolve().parents[1]


def _script(path: str, *args: str, timeout: int = 120) -> str:
    env = dict(os.environ, REPRO_SMOKE="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    p = subprocess.run([sys.executable, str(ROOT / path), *args, "--device", "cpu"], env=env,
                       capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    assert p.returncode == 0, f"{path} failed\n{p.stdout[-2000:]}\n{p.stderr[-2000:]}"
    return p.stdout


def _module(path: str):
    spec = importlib.util.spec_from_file_location(Path(path).stem, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_torch_quickstart():
    out = _script("examples/torch_quickstart.py")
    assert "TRINE" in out
    assert "K* = 8 subnetworks" in out and "step 4: loss" in out


def test_quickstart_shows_the_papers_claims_and_a_falling_loss():
    res = _module("examples/torch_quickstart.py").main(["--device", "cpu"])
    assert res["checks"] and all(res["checks"].values()), res["checks"]
    assert len(res["losses"]) == 5 and np.all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]


def test_example_torch_train_e2e():
    out = _script("examples/torch_train_e2e.py", "--steps", "2")
    assert "final_step" in out or "loss" in out


def test_train_e2e_resumes_after_the_injected_failure():
    res = _module("examples/torch_train_e2e.py").main(
        ["--device", "cpu", "--steps", "24", "--fail-at", "22", "--batch", "2", "--seq", "64"])
    assert res["restarts"] == 1 and res["resumed_from"] == [20]
    steps = [h["step"] for h in res["history"]]
    assert steps == list(range(1, 25))          # every step once: 21-22 replayed
    assert res["history"][-1]["loss"] < res["history"][0]["loss"]


def test_example_torch_continuous_batching():
    out = _script("examples/torch_continuous_batching.py", "--requests", "2",
                  "--slots", "2", "--max-len", "64")
    assert "req" in out


def test_continuous_batching_finishes_every_request():
    res = _module("examples/torch_continuous_batching.py").main(["--device", "cpu"])
    assert len(res["finished"]) == len(res["requests"]) == 12
    assert all(r.done and len(r.out) == r.max_new for r in res["requests"])


def test_example_torch_photonic_mac_ablation():
    out = _script("examples/torch_photonic_mac_ablation.py")
    assert "photonic 8-bit" in out


def test_example_torch_serve_batched():
    out = _script("examples/torch_serve_batched.py")
    assert "prefill:" in out and "decode" in out
    assert "generated shape: (2, 4)" in out


def test_torch_kernels_bench_smoke():
    out = _script("benchmarks/torch_kernels_bench.py")
    for bits in (8, 6, 4, 2):
        assert f"photonic_mac/{bits}bit,rel_err=" in out


def _reference_rel_error(w: np.ndarray, bits: int) -> float:
    wq, sc = j_quantize(jnp.asarray(w), bits=bits)
    deq = np.asarray(jref.dequantize_ref(wq, sc), np.float64)
    return float(np.linalg.norm(deq - w) / np.linalg.norm(w))


@pytest.mark.parametrize("bits", [8, 6, 5, 4, 3, 2])
def test_ablation_quantization_error_equals_the_reference(bits):
    abl = _module("examples/torch_photonic_mac_ablation.py")
    w = abl.bank_weight()
    got = abl.quant_rel_error(torch.as_tensor(w), bits)
    np.testing.assert_allclose(got, _reference_rel_error(w, bits), rtol=1e-5)


@pytest.mark.parametrize("bits", [8, 6, 4, 2])
def test_bench_distortion_equals_the_reference(bits):
    """The bench's distortion: the photonic product against the exact one,
    the reference's quantized weight dequantized and multiplied in f64."""
    bench = _module("benchmarks/torch_kernels_bench.py")
    x, w = bench.inputs(*bench.SHAPE)
    got = bench.distortion(torch.as_tensor(x), torch.as_tensor(w), bits)
    wq, sc = j_quantize(jnp.asarray(w), bits=bits)
    deq = np.asarray(jref.dequantize_ref(wq, sc), np.float64)
    x64 = x.astype(np.float64)
    exact = x64 @ w.astype(np.float64)
    want = float(np.linalg.norm(x64 @ deq - exact) / np.linalg.norm(exact))
    np.testing.assert_allclose(got, want, rtol=1e-4)
