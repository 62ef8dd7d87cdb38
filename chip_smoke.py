#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py                  # everything, as the acceptance check runs it
    python3 chip_smoke.py --only kernels   # stop after the kernel comparisons
    python3 chip_smoke.py --profile        # also: device time by kernel of one decode step

Needs one NVIDIA Hopper GPU, `nvcc` and PyTorch built for CUDA; it raises
(non-zero exit, no result line) without a card.  It builds the CUDA kernels
from `src/repro_torch/csrc/`, then runs four phases, each printing one JSON
line, and fails if any phase fails:

  device            card name and power limit, versions, build seconds
  kernels           `photonic_mac` and `flash_attention` against their plain
                    PyTorch versions on the card, at the shapes of the
                    reference's kernel tests and at yi-6b's serving shapes,
                    with times, a library call's time as yardstick, and the
                    card's bound for the same work
  serve_continuous  yi-6b at full width and depth (bf16, photonic numerics,
                    kernels on, random weights from a seed) behind the
                    `ContinuousBatcher`: ragged requests churn through slots
  serve_batch128    the `launch/serve.py` path at batch 128 x prompt 128, the
                    decode shape whose linears all reach `photonic_mac`; then
                    kernels-on vs kernels-off logits of one prefill

The launch counters are set to 0 before `serve_continuous` and read after
`serve_batch128`; they must equal the counts reckoned from the code.  The
last lines are the `{"kernels": [...]}` summary, the card's name and power
limit, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs one GPU")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs as C  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.photonic_mac import photonic_mac, quantize_weights  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.engine import ContinuousBatcher  # noqa: E402

DEV = torch.device("cuda")
SEED = 0

# Published dense peaks of one H100 SXM (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# yi-6b's linears as (K, N): wq/wo, wk/wv, wg/wi, mlp wo, lm_head
YI_KN = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096), (4096, 64000)]
MAC_HEADLINE = (128, 4096, 11008)        # the shape reported in the summary line
ATTN_HEADLINE = (1, 128)                 # (batch, prompt length) reported in the summary


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn) -> float:
    """Mean device time of `fn` in ms, by CUDA events around a run of calls
    (3 to 50, about 20 ms of work).  The device is first kept busy with a
    spin kernel while the host enqueues the whole run, so the events bracket
    back-to-back device work and not the host's cost of launching it.
    Inputs are a few MB to tens of MB and stay warm in L2 between calls, as
    they are on the serving path, where each is produced just before use."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    fn()
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    iters = max(3, min(50, int(20.0 / max(e0.elapsed_time(e1), 1e-3))))
    torch.cuda._sleep(10_000_000)          # a few ms of spinning
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def compare(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float, what: str) -> dict:
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: bad shape or non-finite values")
    diff = (got - want).abs()
    excess = float((diff - (atol + rtol * want.abs())).max())
    res = {"what": what, "max_abs_err": float(diff.max()),
           "max_rel_err": float(diff.max() / want.abs().max().clamp_min(1e-30)),
           "rtol": rtol, "atol": atol}
    if excess > 0:
        raise AssertionError(f"kernel disagrees with its plain version: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    info = {"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0],
            "build_seconds": round(_build.build_seconds, 2),
            "ptxas": [ln.strip() for ln in _build.build_log.splitlines()
                      if "registers" in ln or ("spill" in ln and "0 bytes spill" not in ln)]}
    emit(info)
    return info


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _mac_inputs(gen, m, k, n, dtype, bits):
    x = torch.randn((m, k), generator=gen, device=DEV).to(dtype)
    w = torch.randn((k, n), generator=gen, device=DEV)
    w_q, sc = quantize_weights(w, bits=bits)
    return x, w_q, sc


def mac_bound_ms(m, k, n, dtype) -> dict:
    nbytes = m * k * (2 if dtype == torch.bfloat16 else 4) + k * n + 4 * (-(-k // 128)) * (-(-n // 128)) + 4 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * k * n / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_photonic_mac(gen) -> dict:
    checks, timed = [], []
    # the reference's kernel-test shapes
    for (m, k, n) in [(128, 128, 128), (256, 384, 128), (128, 256, 512), (384, 128, 256)]:
        for dtype in (torch.float32, torch.bfloat16):
            for bits in (8, 4):
                x, w_q, sc = _mac_inputs(gen, m, k, n, dtype, bits)
                tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
                checks.append(compare(photonic_mac(x, w_q, sc), ref.photonic_mac_ref(x, w_q, sc),
                                      tol, tol * 10, f"mac {m}x{k}x{n} {dtype} bits{bits}"))
    # ragged shapes; (130, 136, 144) still meets the tensor-core kernel's alignment
    for (m, k, n) in [(100, 128, 128), (128, 200, 300), (1, 128, 50257 % 512), (130, 129, 131),
                      (130, 136, 144)]:
        for dtype in (torch.float32, torch.bfloat16):
            x, w_q, sc = _mac_inputs(gen, m, k, n, dtype, 8)
            tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
            checks.append(compare(photonic_mac(x, w_q, sc), ref.photonic_mac_ref(x, w_q, sc),
                                  tol, tol * 10, f"mac ragged {m}x{k}x{n} {dtype}"))
    # rows must not depend on how many rows lie below them
    for dtype in (torch.float32, torch.bfloat16):
        x, w_q, sc = _mac_inputs(gen, 128, 256, 256, dtype, 8)
        for tc in (True, False):
            full = photonic_mac(x, w_q, sc, tensor_cores=tc)
            part = photonic_mac(x[:100].contiguous(), w_q, sc, tensor_cores=tc)
            torch.cuda.synchronize()
            if not torch.equal(part, full[:100]):
                raise AssertionError("photonic_mac: rows differ with and without padded rows "
                                     f"({dtype}, tensor_cores={tc})")
        checks.append({"what": f"mac bit-identity 100 of 128 rows {dtype}", "max_abs_err": 0.0})
    # yi-6b's serving shapes, bf16 activations as on the path
    shapes = [(m, k, n) for m in (128, 512) for (k, n) in YI_KN]
    shapes.append((128 * 128, 4096, 11008))      # the batch-128 prefill's widest linear
    for (m, k, n) in shapes:
        x, w_q, sc = _mac_inputs(gen, m, k, n, torch.bfloat16, 8)
        want = ref.photonic_mac_ref(x, w_q, sc)
        checks.append(compare(photonic_mac(x, w_q, sc), want, 2e-2, 2e-1,
                              f"mac yi-6b {m}x{k}x{n} bf16"))
        checks.append(compare(photonic_mac(x, w_q, sc, tensor_cores=False), want, 2e-2, 2e-1,
                              f"mac yi-6b {m}x{k}x{n} bf16, f32 FMA kernel"))
        del want
        w_bf16 = ref.dequantize_ref(w_q, sc).to(torch.bfloat16)
        row = {"shape": [m, k, n], "dtype": "bfloat16",
               "ms": time_ms(lambda: photonic_mac(x, w_q, sc)),
               "fma_kernel_ms": time_ms(lambda: photonic_mac(x, w_q, sc, tensor_cores=False)),
               "plain_ms": time_ms(lambda: ref.photonic_mac_ref(x, w_q, sc)),
               "library_ms": time_ms(lambda: torch.matmul(x, w_bf16)),
               **mac_bound_ms(m, k, n, torch.bfloat16)}
        timed.append(row)
        del w_bf16
    return {"checks": checks, "timed": timed}


def _attn_inputs(gen, b, hq, hk, sq, sk, d, dtype, model_layout=False):
    """q, k, v as (B,H,S,D); with `model_layout`, strided views of (B,S,H,D)
    tensors, which is how `layers.apply_attention` hands them over."""
    def mk(h, s):
        if model_layout:
            return torch.randn((b, s, h, d), generator=gen, device=DEV).to(dtype).movedim(2, 1)
        return torch.randn((b, h, s, d), generator=gen, device=DEV).to(dtype)
    return mk(hq, sq), mk(hk, sk), mk(hk, sk)


def attn_bound_ms(b, hq, hk, sq, sk, d, dtype, causal, window, q_offset) -> dict:
    q_pos = q_offset + torch.arange(sq)[:, None]
    k_pos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    pairs = int(mask.sum())                      # (query, key) pairs this mask needs
    esize = 2 if dtype == torch.bfloat16 else 4
    nbytes = esize * b * d * (hq * sq + 2 * hk * sk) + 4 * b * hq * sq * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * d * pairs * b * hq / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_flash_attention(gen) -> dict:
    checks, timed = [], []
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for (sq, sk, hq, hk, d) in [(128, 128, 4, 4, 64), (256, 256, 8, 2, 64), (128, 256, 8, 1, 128),
                                (512, 512, 2, 2, 32), (128, 384, 16, 8, 64)]:
        for window in (0, 64):
            cases.append((2, hq, hk, sq, sk, d, f32, True, window, sk - sq))
    cases += [
        (1, 4, 4, 128, 128, 64, bf16, True, 0, 0),          # the reference's bf16 case
        (2, 8, 2, 256, 256, 64, bf16, True, 64, 0),         # the f32 cases again in bf16,
        (2, 2, 2, 512, 512, 32, bf16, True, 0, 0),          # one per head size
        (2, 4, 2, 100, 100, 16, bf16, True, 24, 0),
        (1, 2, 2, 128, 128, 32, bf16, False, 0, 0),
        (1, 2, 2, 16, 16, 16, bf16, True, 4, 32),           # fully masked rows in bf16
        (1, 2, 2, 128, 128, 32, f32, False, 0, 0),          # non-causal
        (2, 4, 2, 40, 40, 16, f32, True, 0, 0),             # ragged: S below one tile
        (2, 4, 2, 100, 100, 16, f32, True, 24, 0),          # ragged: S between tiles
        (1, 2, 2, 16, 16, 16, f32, True, 4, 32),            # fully masked rows: no tile skipping
        (1, 8, 2, 128, 384, 128, bf16, True, 64, 256),
    ]
    for (b, hq, hk, sq, sk, d, dtype, causal, window, off) in cases:
        q, k, v = _attn_inputs(gen, b, hq, hk, sq, sk, d, dtype)
        kw = dict(causal=causal, window=window, q_offset=off)
        what = (f"attn b{b} hq{hq} hk{hk} sq{sq} sk{sk} d{d} {dtype} causal{int(causal)} "
                f"w{window} off{off}")
        want = ref.attention_ref(q, k, v, **kw)
        if dtype == bf16:    # both kernels that take bf16, at bf16's tolerance
            checks.append(compare(flash_attention(q, k, v, **kw), want, 2e-2, 2e-2, what))
            checks.append(compare(flash_attention(q, k, v, tensor_cores=False, **kw), want,
                                  2e-2, 2e-2, what + ", f32 FMA kernel"))
        else:
            checks.append(compare(flash_attention(q, k, v, **kw), want, 2e-5, 2e-5, what))
    # yi-6b's prefill shapes: strided (B,S,H,D) projections, bf16, causal
    for (b, s) in [(1, 128), (1, 256), (1, 512), (128, 128)]:
        q, k, v = _attn_inputs(gen, b, 32, 4, s, s, 128, bf16, model_layout=True)
        if b == 1:
            checks.append(compare(flash_attention(q, k, v), ref.attention_ref(q, k, v),
                                  2e-2, 2e-2, f"attn yi-6b b{b} s{s} bf16"))
        else:   # the plain version would hold (128,32,128,128) f32 scores twice: check 4 rows
            out = flash_attention(q, k, v)
            checks.append(compare(out[:4], ref.attention_ref(q[:4], k[:4], v[:4]),
                                  2e-2, 2e-2, f"attn yi-6b b{b} s{s} bf16 (first 4 of batch)"))
        kr, vr = k.repeat_interleave(8, dim=1), v.repeat_interleave(8, dim=1)
        row = {"shape": {"b": b, "hq": 32, "hk": 4, "s": s, "d": 128}, "dtype": "bfloat16",
               "ms": time_ms(lambda: flash_attention(q, k, v)),
               "fma_kernel_ms": time_ms(lambda: flash_attention(q, k, v, tensor_cores=False)),
               "plain_ms": time_ms(lambda: ref.attention_ref(q, k, v)),
               "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, kr, vr, is_causal=True)),
               **attn_bound_ms(b, 32, 4, s, s, 128, bf16, True, 0, 0)}
        timed.append(row)
    return {"checks": checks, "timed": timed}


def quantize_cost_ms(gen) -> dict:
    """Device time of re-quantizing the master weights, which `photonic_matmul`
    does on every call: per yi-6b matrix, and summed over one decode step
    (seven matrices in each of 32 layers, plus the head)."""
    per = {}
    for (k, n) in YI_KN:
        w = torch.randn((k, n), generator=gen, device=DEV)
        per[f"{k}x{n}"] = time_ms(lambda: quantize_weights(w, bits=8))
        del w
    layer = (2 * per["4096x4096"] + 2 * per["4096x512"] + 2 * per["4096x11008"]
             + per["11008x4096"])
    return {"per_matrix_ms": per, "per_decode_step_ms": 32 * layer + per["4096x64000"]}


def phase_kernels() -> dict:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    before = (photonic_mac.launches, flash_attention.launches)
    mac = check_photonic_mac(gen)
    attn = check_flash_attention(gen)
    quant = quantize_cost_ms(gen)
    if photonic_mac.launches == before[0] or flash_attention.launches == before[1]:
        raise AssertionError("a kernel comparison launched no kernel")
    out = {"phase": "kernels",
           "photonic_mac": {"n_checks": len(mac["checks"]),
                            "max_abs_err": max(c["max_abs_err"] for c in mac["checks"]),
                            "max_rel_err": max(c.get("max_rel_err", 0.0) for c in mac["checks"]),
                            "tolerance": "f32 rtol 1e-4 atol 1e-3; bf16 rtol 2e-2 atol 2e-1; "
                                         "padded rows bit-identical",
                            "timed": mac["timed"]},
           "flash_attention": {"n_checks": len(attn["checks"]),
                               "max_abs_err": max(c["max_abs_err"] for c in attn["checks"]),
                               "max_rel_err": max(c["max_rel_err"] for c in attn["checks"]),
                               "tolerance": "f32 rtol=atol 2e-5; bf16 rtol=atol 2e-2",
                               "timed": attn["timed"]},
           "quantize_weights": quant}
    emit(out)
    out["checks"] = mac["checks"] + attn["checks"]
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving path at yi-6b's full width and depth
# ---------------------------------------------------------------------------


LINEARS_PER_LAYER = 7     # wq, wk, wv, wo, wg, wi, mlp wo


def expected_prefill_launches(cfg, batch: int, plen: int) -> tuple:
    """(photonic_mac, flash_attention) launches of one prefill call, from the
    dispatch predicates in `kernels/ops.py`."""
    m, f, h, hk, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    rows = batch * plen
    shapes = [(m, h * dh), (m, hk * dh), (m, hk * dh), (h * dh, m), (m, f), (m, f), (f, m)]
    assert len(shapes) == LINEARS_PER_LAYER
    mac = cfg.n_layers * sum(ops.uses_tiled_path(rows, k, n) for k, n in shapes)
    mac += int(ops.uses_tiled_path(batch, m, cfg.vocab))        # the head sees x[:, -1:]
    attn = cfg.n_layers * int(ops.uses_flash_kernel(plen, plen, 0))
    return mac, attn


def expected_decode_launches(cfg, batch: int) -> int:
    return expected_prefill_launches(cfg, batch, 1)[0]


def phase_serve_continuous(cfg, params) -> dict:
    n_slots, max_len, bucket = 4, 512, 128
    rng = torch.Generator()
    rng.manual_seed(SEED + 1)
    lengths = [60, 250, 131, 97, 200, 129, 77, 180]
    max_news = [4, 8, 6, 5, 7, 4, 8, 6]
    prompts = [torch.randint(2, cfg.vocab, (n,), generator=rng).tolist() for n in lengths]

    mac0, attn0 = photonic_mac.launches, flash_attention.launches
    eng = ContinuousBatcher(cfg, params, n_slots=n_slots, max_len=max_len,
                            prompt_bucket=bucket, device=DEV)
    reqs = [eng.submit(p, mn) for p, mn in zip(prompts, max_news)]
    t0 = time.perf_counter()
    finished = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    assert len(finished) == len(reqs) and all(r.done for r in reqs), "requests left unfinished"
    for r, mn in zip(reqs, max_news):
        assert len(r.out) == mn, (r.rid, len(r.out), mn)
        assert all(0 <= t < cfg.vocab for t in r.out), "token id out of range"
    want_mac = want_attn = 0
    for n in lengths:
        plen = -(-(n - 1) // bucket) * bucket
        a, b = expected_prefill_launches(cfg, 1, plen)
        want_mac, want_attn = want_mac + a, want_attn + b
    want_mac += eng.stats["decode_iters"] * expected_decode_launches(cfg, n_slots)
    got_mac, got_attn = photonic_mac.launches - mac0, flash_attention.launches - attn0
    assert (got_mac, got_attn) == (want_mac, want_attn), \
        f"launch counts {(got_mac, got_attn)} differ from the code's {(want_mac, want_attn)}"
    # one more decode step by hand to look at the logits themselves
    logits, _ = M.serve_step(cfg, params, eng.cache, eng.last_tok[:, None], eng.pos, device=DEV)
    assert tuple(logits.shape) == (n_slots, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    st = eng.stats
    out = {"phase": "serve_continuous", "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "dtype": cfg.dtype,
           "n_slots": n_slots, "max_len": max_len, "prompt_bucket": bucket,
           "requests": len(reqs), "prompt_lengths": lengths, "max_new": max_news,
           "prefill_calls": st["prefill_calls"], "prefill_tokens": st["prefill_tokens"],
           "prefill_s": st["prefill_s"], "prefill_tokens_per_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_iters": st["decode_iters"], "decode_tokens": st["decode_tokens"],
           "decode_s": st["decode_s"], "decode_tokens_per_s": st["decode_tokens"] / st["decode_s"],
           "wall_s": wall, "photonic_mac_launches": got_mac, "flash_attention_launches": got_attn,
           "sample": reqs[0].out}
    emit(out)
    return out


def phase_serve_batch128(cfg, params) -> dict:
    batch, plen, max_new = 128, 128, 4
    mac0, attn0 = photonic_mac.launches, flash_attention.launches
    res = serve.main(["--arch", "yi-6b", "--batch", str(batch), "--prompt-len", str(plen),
                      "--max-new", str(max_new), "--seed", str(SEED), "--photonic", "--kernels"],
                     params=params)
    got_mac, got_attn = photonic_mac.launches - mac0, flash_attention.launches - attn0
    pf_mac, pf_attn = expected_prefill_launches(cfg, batch, plen)
    per_step = expected_decode_launches(cfg, batch)
    assert per_step == cfg.n_layers * LINEARS_PER_LAYER + 1, per_step
    want = (pf_mac + (max_new - 1) * per_step, pf_attn)
    assert (got_mac, got_attn) == want, f"launch counts {(got_mac, got_attn)} differ from {want}"
    toks, logits = res["tokens"], res["logits"]
    assert tuple(toks.shape) == (batch, max_new)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    assert tuple(logits.shape) == (batch, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    out = {"phase": "serve_batch128", "model": cfg.name, "batch": batch, "prompt_len": plen,
           "max_new": max_new, "prefill_s": res["prefill_s"],
           "prefill_tokens_per_s": res["prefill_tokens"] / res["prefill_s"],
           "decode_s": res["decode_s"], "decode_steps": max_new - 1,
           "decode_tokens_per_s": res["decode_tokens"] / res["decode_s"],
           "photonic_mac_launches": got_mac, "flash_attention_launches": got_attn,
           "launches_per_prefill": [pf_mac, pf_attn], "photonic_mac_launches_per_decode_step": per_step,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    return out


def phase_end_to_end(cfg, params) -> dict:
    """The same prefill with the CUDA kernels and with their plain versions
    (the reference's own `use_kernels=False` configuration: same tiled
    quantization, plain matmul and attention).  bf16 activations are rounded
    after every linear, so the two runs drift apart by bf16 rounding over 32
    layers; they are held to 3e-2 of the largest logit."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 2)
    toks = torch.randint(2, cfg.vocab, (1, 128), generator=gen, device=DEV)
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    mac0 = photonic_mac.launches
    lg_k, _ = M.prefill(cfg, params, {"tokens": toks}, device=DEV)
    used = photonic_mac.launches - mac0
    lg_p, _ = M.prefill(plain_cfg, params, {"tokens": toks}, device=DEV)
    torch.cuda.synchronize()
    assert photonic_mac.launches - mac0 == used, "use_kernels=False launched a kernel"
    assert bool(torch.isfinite(lg_k).all()) and bool(torch.isfinite(lg_p).all())
    rel = float((lg_k - lg_p).abs().max() / lg_p.abs().max())
    out = {"phase": "end_to_end", "what": "last-token logits, kernels vs plain versions, B=1 S=128",
           "max_rel_to_largest_logit": rel, "tolerance": 3e-2,
           "argmax_equal": bool(lg_k.argmax() == lg_p.argmax())}
    emit(out)
    assert rel < 3e-2, out
    return out


def phase_profile(cfg, params) -> dict:
    """Device time by kernel of one batch-128 decode step and of one
    B=1, S=128 prefill, from `torch.profiler` (optional, `--profile`)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 3)
    prompts = torch.randint(2, cfg.vocab, (128, 128), generator=gen, device=DEV)
    logits, cache = M.prefill(cfg, params, {"tokens": prompts}, cache_len=132, device=DEV)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]

    def window(fn) -> dict:
        fn()                                           # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        def dev_us(e):
            return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        busy_ms = sum(dev_us(e) for e in kernels) / 1e3
        top = sorted(kernels, key=dev_us, reverse=True)[:10]
        return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
                "kernel_launches": sum(e.count for e in kernels),
                "top_kernels": [{"name": e.key[:60], "calls": e.count, "ms": dev_us(e) / 1e3}
                                for e in top]}

    out = {"phase": "profile",
           "decode_step_b128": window(lambda: M.serve_step(cfg, params, cache, tok, 128, device=DEV)),
           "prefill_b1_s128": window(lambda: M.prefill(cfg, params, {"tokens": prompts[:1]},
                                                       device=DEV))}
    emit(out)
    return out


# ---------------------------------------------------------------------------


def kernel_summary(kern: dict, launches: dict) -> dict:
    def pick(rows, match):
        return next(r for r in rows if match(r))
    mac = pick(kern["photonic_mac"]["timed"], lambda r: tuple(r["shape"]) == MAC_HEADLINE)
    att = pick(kern["flash_attention"]["timed"],
               lambda r: (r["shape"]["b"], r["shape"]["s"]) == ATTN_HEADLINE)
    return {"kernels": [
        {"name": "photonic_mac", "route": "cuda",
         "source": "src/repro_torch/csrc/photonic_mac.cu",
         "replaces": "src/repro/kernels/photonic_mac.py:60",
         "launches": launches["photonic_mac"],
         "max_abs_err": kern["photonic_mac"]["max_abs_err"],
         "ms": mac["ms"], "plain_ms": mac["plain_ms"], "bound_ms": mac["bound_ms"],
         "bound_by": mac["bound_by"], "library_ms": mac["library_ms"],
         "shape": {"m": MAC_HEADLINE[0], "k": MAC_HEADLINE[1], "n": MAC_HEADLINE[2],
                   "x": "bfloat16"}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:81",
         "launches": launches["flash_attention"],
         "max_abs_err": kern["flash_attention"]["max_abs_err"],
         "ms": att["ms"], "plain_ms": att["plain_ms"], "bound_ms": att["bound_ms"],
         "bound_by": att["bound_by"], "library_ms": att["library_ms"],
         "shape": {**att["shape"], "qkv": "bfloat16", "causal": True}},
    ]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["kernels"], default=None,
                    help="stop after this phase (for work on a kernel); prints no ok line")
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel for one decode step and one prefill")
    args = ap.parse_args()
    t_start = time.perf_counter()
    dev = phase_device()
    kern = phase_kernels()
    if args.only == "kernels":
        for c in kern["checks"]:
            emit(c)
        print(dev["nvidia_smi"], flush=True)
        return

    cfg = dataclasses.replace(C.get("yi_6b"), use_photonic_mac=True, use_kernels=True)
    t0 = time.perf_counter()
    params = M.init(cfg, seed=SEED, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    emit({"phase": "init", "model": cfg.name, "parameters": n_params,
          "master_dtype": "float32", "seconds": time.perf_counter() - t0})

    # the main path: counters to 0 just before, read just after
    photonic_mac.launches = 0
    flash_attention.launches = 0
    phase_serve_continuous(cfg, params)
    phase_serve_batch128(cfg, params)
    launches = {"photonic_mac": photonic_mac.launches, "flash_attention": flash_attention.launches}
    for name, n in launches.items():
        assert n > 0, f"the main path never launched {name}"

    phase_end_to_end(cfg, params)
    if args.profile:
        phase_profile(cfg, params)

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit(kernel_summary(kern, launches))
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
