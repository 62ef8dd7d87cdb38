"""Parity of the PyTorch port's kernel layer with the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
`repro_torch`.  The JAX side runs as its own tests run it here: the jnp
oracles, and the Pallas kernels in interpret mode.  The port runs on CPU
tensors and therefore through its plain versions (the CUDA kernels are held
against those plain versions on the card by `chip_smoke.py`).

Tolerances: quantized levels and scales are exact (same IEEE f32 divide and
round-half-even on both sides); f32 products differ only in summation order
(rtol 1e-4 for the MAC, 2e-5 for attention, the reference's own bounds);
bf16 inputs are rounded identically on both sides, so the f32 bounds hold.
The scan's plain versions match the jnp oracles to 1e-5 (same f32
recurrence, other summation order); the port's scan against the Pallas
kernel uses the reference test's 2e-4, gradients its 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.photonic_mac import photonic_mac as j_mac
from repro.kernels.photonic_mac import quantize_weights as j_quantize
from repro.kernels.ssm_scan import ssm_scan as j_ssm_scan

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.photonic_mac import (
    SEQ_BLOCKS, dispatch, mac_plan, mac_ranges, mac_splits, photonic_mac, quantize_weights)
from repro_torch.kernels.ssm_scan import ssm_scan


def _rng(*seed):
    return np.random.default_rng(list(seed))


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


def _j(a, bf16=False):
    return jnp.asarray(a, jnp.bfloat16 if bf16 else None)


# ---------------------------------------------------------------------------
# quantize_weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n", [(256, 384), (128, 128), (200, 300), (130, 129), (1, 50)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weights_levels_and_scales_equal(k, n, bits):
    w = _rng(k, n, bits).standard_normal((k, n)).astype(np.float32)
    wq_j, sc_j = j_quantize(_j(w), bits=bits)
    wq_t, sc_t = quantize_weights(_t(w), bits=bits)
    assert wq_t.dtype == torch.int8 and sc_t.dtype == torch.float32
    assert tuple(wq_t.shape) == (k, n)
    assert tuple(sc_t.shape) == (-(-k // 128), -(-n // 128))
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))


def test_quantize_weights_all_zero_tile():
    """A tile of zeros takes the epsilon scale and zero levels on both sides."""
    w = _rng(5).standard_normal((256, 256)).astype(np.float32)
    w[128:, :128] = 0.0
    wq_j, sc_j = j_quantize(_j(w))
    wq_t, sc_t = quantize_weights(_t(w))
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    assert float(sc_t[1, 0]) == pytest.approx(1e-8 / 127, rel=1e-6)
    assert not wq_t[128:, :128].any()


def test_quantize_padding_is_exact_on_shared_tiles():
    w = _rng(3).standard_normal((256, 256)).astype(np.float32)
    wq_a, sc_a = quantize_weights(_t(w))
    wq_b, sc_b = quantize_weights(_t(w[:200, :250]))
    assert torch.equal(sc_b[:1, :1], sc_a[:1, :1])
    assert torch.equal(wq_b[:128, :128], wq_a[:128, :128])


# ---------------------------------------------------------------------------
# photonic MAC: plain version vs the jnp oracle and the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (128, 256, 512), (384, 128, 256)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_photonic_mac_ref_matches_reference(m, k, n, bf16, bits):
    r = _rng(m, k, n, bits)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = r.standard_normal((k, n)).astype(np.float32)
    wq_j, sc_j = j_quantize(_j(w), bits=bits)
    wq_t, sc_t = quantize_weights(_t(w), bits=bits)
    xj, xt = _j(x, bf16), _t(x, torch.bfloat16 if bf16 else None)
    out_t = photonic_mac(xt, wq_t, sc_t)        # CPU tensor -> plain version
    assert out_t.dtype == torch.float32 and tuple(out_t.shape) == (m, n)
    oracle = np.asarray(jref.photonic_mac_ref(xj, wq_j, sc_j))
    kernel = np.asarray(j_mac(xj, wq_j, sc_j, interpret=True))
    np.testing.assert_allclose(out_t.numpy(), oracle, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(out_t.numpy(), kernel, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("m,k,n", [(100, 128, 128), (128, 200, 300),
                                   (1, 128, 50257 % 512), (130, 129, 131)])
def test_photonic_mac_ref_non_aligned_shapes(m, k, n):
    r = _rng(m, k, n)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = r.standard_normal((k, n)).astype(np.float32)
    wq_j, sc_j = j_quantize(_j(w))
    wq_t, sc_t = quantize_weights(_t(w))
    out_t = photonic_mac(_t(x), wq_t, sc_t)
    assert tuple(out_t.shape) == (m, n)
    kernel = np.asarray(j_mac(_j(x), wq_j, sc_j, interpret=True))
    np.testing.assert_allclose(out_t.numpy(), kernel, rtol=1e-4, atol=1e-3)


def test_dequantize_ref_matches_reference():
    w = _rng(11).standard_normal((200, 300)).astype(np.float32)
    wq_t, sc_t = quantize_weights(_t(w))
    wq_j, sc_j = j_quantize(_j(w))
    np.testing.assert_array_equal(ref.dequantize_ref(wq_t, sc_t).numpy(),
                                  np.asarray(jref.dequantize_ref(wq_j, sc_j)))


def test_photonic_mac_wrapper_rejects_bad_inputs():
    x = torch.zeros(4, 128)
    wq = torch.zeros(128, 128, dtype=torch.int8)
    sc = torch.ones(1, 1)
    with pytest.raises(ValueError):
        photonic_mac(x, wq, torch.ones(2, 1))
    with pytest.raises(TypeError):
        photonic_mac(x, wq.to(torch.int32), sc)
    with pytest.raises(TypeError):
        photonic_mac(x.to(torch.float16), wq, sc)
    with pytest.raises(ValueError):
        photonic_mac(torch.zeros(4, 64), wq, sc)


# ---------------------------------------------------------------------------
# attention: plain version vs the jnp oracle and the Pallas kernel
# ---------------------------------------------------------------------------

def _qkv(r, b, hq, hk, sq, sk, d):
    q = r.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = r.standard_normal((b, hk, sk, d)).astype(np.float32)
    v = r.standard_normal((b, hk, sk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("sq,sk,hq,hk,d", [
    (128, 128, 4, 4, 64),      # MHA
    (256, 256, 8, 2, 64),      # GQA 4:1
    (128, 256, 8, 1, 128),     # MQA, longer KV
    (512, 512, 2, 2, 32),      # long, small heads
    (128, 384, 16, 8, 64),     # GQA 2:1, 3x KV
])
@pytest.mark.parametrize("window", [0, 64])
def test_attention_ref_matches_reference(sq, sk, hq, hk, d, window):
    q, k, v = _qkv(_rng(sq, sk, hq, window), 1, hq, hk, sq, sk, d)
    off = sk - sq
    out_t = flash_attention(_t(q), _t(k), _t(v), causal=True, window=window,
                            q_offset=off)     # CPU tensors -> plain version
    assert out_t.dtype == torch.float32
    oracle = jref.attention_ref(_j(q), _j(k), _j(v), causal=True, window=window,
                                q_offset=off)
    kernel = j_flash(_j(q), _j(k), _j(v), causal=True, window=window,
                     q_offset=off, interpret=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(oracle), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(kernel), rtol=2e-5, atol=2e-5)


def test_attention_ref_bf16_inputs():
    q, k, v = _qkv(_rng(7), 1, 4, 4, 128, 128, 64)
    bf = torch.bfloat16
    out_t = ref.attention_ref(_t(q, bf), _t(k, bf), _t(v, bf))
    exp = jref.attention_ref(_j(q, True), _j(k, True), _j(v, True))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(exp), rtol=2e-5, atol=2e-5)


def test_attention_ref_noncausal():
    q, k, v = _qkv(_rng(9), 1, 2, 2, 128, 128, 32)
    out_t = ref.attention_ref(_t(q), _t(k), _t(v), causal=False)
    exp = j_flash(_j(q), _j(k), _j(v), causal=False, interpret=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(exp), rtol=2e-5, atol=2e-5)


def test_attention_fully_masked_rows_average_all_keys():
    """Rows with no visible key (q_offset + Sq > Sk under a window) give the
    plain average of V in the reference kernel, the jnp oracle and the port."""
    q, k, v = _qkv(_rng(13), 1, 2, 2, 16, 16, 16)
    kw = dict(causal=True, window=4, q_offset=32)
    out_t = ref.attention_ref(_t(q), _t(k), _t(v), **kw)
    exp = j_flash(_j(q), _j(k), _j(v), interpret=True, **kw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(exp), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out_t.numpy()[0, :, -1], v[0].mean(axis=1),
                               rtol=1e-5, atol=1e-6)


def test_flash_attention_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 4, 16, 16)
    k = torch.zeros(1, 3, 16, 16)
    with pytest.raises(ValueError):
        flash_attention(q, k, k)                       # 4 % 3 != 0
    k = torch.zeros(1, 2, 16, 16)
    with pytest.raises(TypeError):
        flash_attention(q, k.to(torch.bfloat16), k)    # mixed dtypes
    with pytest.raises(ValueError):
        flash_attention(q, k, torch.zeros(1, 2, 8, 16))


# ---------------------------------------------------------------------------
# ops: dispatch predicates and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,tiled", [(128, 128, 128, True), (256, 128, 256, True),
                                         (64, 64, 128, False), (100, 128, 128, False),
                                         (128, 128, 96, False)])
@pytest.mark.parametrize("bits", [8, 4])
def test_photonic_matmul_both_sides_of_the_predicate(m, k, n, tiled, bits):
    """Tiled shapes use per-tile scales, the rest one scale per column; the
    port reproduces the reference's predicate and both numerics."""
    assert ops.uses_tiled_path(m, k, n) == tiled
    r = _rng(m, k, n, bits)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = r.standard_normal((k, n)).astype(np.float32)
    for use_kernel in (False, True):
        out_t = ops.photonic_matmul(_t(x), _t(w), bits, use_kernel)
        exp = jops.photonic_matmul(_j(x), _j(w), bits, use_kernel)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(exp), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (64, 64, 128)])
def test_photonic_matmul_straight_through_gradients(m, k, n):
    r = _rng(m, k, n)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = r.standard_normal((k, n)).astype(np.float32)
    g = r.standard_normal((m, n)).astype(np.float32)
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    (ops.photonic_matmul(xt, wt, 8, False) * _t(g)).sum().backward()
    dx_j, dw_j = jax.grad(
        lambda x_, w_: jnp.sum(jops.photonic_matmul(x_, w_, 8, False) * _j(g)),
        argnums=(0, 1))(_j(x), _j(w))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), rtol=1e-4, atol=1e-4)
    # straight-through: dw is the unquantized matmul's gradient
    np.testing.assert_allclose(wt.grad.numpy(), x.T @ g, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sq,sk,off,use_kernel,expect", [
    (128, 128, 0, True, True), (40, 40, 0, True, True), (256, 384, 128, True, True),
    (130, 130, 0, True, False), (4, 4, 0, True, False), (64, 128, 32, True, False),
    (128, 128, 0, False, False)])
def test_attention_dispatch_predicate(sq, sk, off, use_kernel, expect):
    assert ops.uses_flash_kernel(sq, sk, off, use_kernel) == expect


@pytest.mark.parametrize("sq,sk,window,use_kernel", [(64, 64, 0, True), (64, 64, 16, True),
                                                     (33, 33, 0, True), (32, 64, 0, False)])
def test_ops_attention_forward_and_gradients(sq, sk, window, use_kernel):
    q, k, v = _qkv(_rng(sq, sk, window), 2, 4, 2, sq, sk, 16)
    g = _rng(1, sq).standard_normal((2, 4, sq, 16)).astype(np.float32)
    off = sk - sq
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out_t = ops.attention(*ts, True, window, None, off, use_kernel)
    (out_t * _t(g)).sum().backward()

    def f(q_, k_, v_):
        return jops.attention(q_, k_, v_, True, window, None, off, use_kernel)
    out_j = f(_j(q), _j(k), _j(v))
    grads_j = jax.grad(lambda *a: jnp.sum(f(*a) * _j(g)), argnums=(0, 1, 2))(
        _j(q), _j(k), _j(v))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=2e-5, atol=2e-5)
    for t, gj in zip(ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# ssm scan: plain versions vs the jnp oracles and the Pallas kernel
# ---------------------------------------------------------------------------

def _ssm_inputs(r, bh, l, p, n, decay=(0.68, 0.98)):
    """The reference tests' distribution: x * 0.5, b and c * 0.3, a in `decay`."""
    x = (r.standard_normal((bh, l, p)) * 0.5).astype(np.float32)
    lo, hi = decay
    a = (lo + (hi - lo) / (1.0 + np.exp(-r.standard_normal((bh, l))))).astype(np.float32)
    b = (r.standard_normal((bh, l, n)) * 0.3).astype(np.float32)
    c = (r.standard_normal((bh, l, n)) * 0.3).astype(np.float32)
    return x, a, b, c


SSM_SHAPES = [(2, 128, 16, 8), (4, 256, 32, 16), (1, 512, 64, 64), (8, 128, 8, 4),
              (2, 1024, 32, 32)]       # the reference's kernel-test shapes


@pytest.mark.parametrize("bh,l,p,n", SSM_SHAPES + [(3, 97, 8, 4), (2, 24, 1, 16)])
def test_ssm_scan_ref_matches_reference(bh, l, p, n):
    x, a, b, c = _ssm_inputs(_rng(bh, l, p, n), bh, l, p, n)
    out_t = ref.ssm_scan_ref(_t(x), _t(a), _t(b), _t(c))
    assert out_t.dtype == torch.float32 and tuple(out_t.shape) == (bh, l, p)
    exp = jref.ssm_scan_ref(_j(x), _j(a), _j(b), _j(c))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(exp), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bh,l,p,n,chunk", [
    (2, 128, 16, 8, 128), (4, 256, 32, 16, 128), (1, 512, 64, 64, 128),
    (2, 256, 16, 8, 64), (3, 96, 8, 4, 128), (2, 200, 8, 4, 128)])   # last two: sequential
@pytest.mark.parametrize("dtypes", ["f32", "bf16", "x_f32_bc_bf16"])
def test_ssm_scan_chunked_ref_matches_reference(bh, l, p, n, chunk, dtypes):
    """Including the reference's bf16 rounding: with bf16 x every big operand
    is rounded to bf16 before its product; with f32 x (mLSTM's normaliser)
    bf16 b and c are widened and nothing is rounded."""
    x, a, b, c = _ssm_inputs(_rng(bh, l, p, n, chunk), bh, l, p, n)
    bx, bbc = dtypes == "bf16", dtypes != "f32"
    args = (_t(x, torch.bfloat16 if bx else None), _t(a),
            _t(b, torch.bfloat16 if bbc else None), _t(c, torch.bfloat16 if bbc else None))
    out_t = ref.ssm_scan_chunked_ref(*args, chunk=chunk)
    exp = np.asarray(jref.ssm_scan_chunked_ref(_j(x, bx), _j(a), _j(b, bbc), _j(c, bbc),
                                               chunk=chunk), np.float32)
    assert out_t.dtype == torch.float32
    if not (bx and l % min(chunk, l) == 0):
        np.testing.assert_allclose(out_t.numpy(), exp, rtol=1e-5, atol=1e-5)
        return
    # bf16 roundings inside the chunked form: a product within one f32 ulp of
    # a bf16 rounding boundary (the two sides sum in other orders) rounds the
    # other way and moves its outputs by up to one bf16 step of that term.
    # So: nearly every element at 1e-5, and none beyond one such step ...
    close = np.isclose(out_t.numpy(), exp, rtol=1e-5, atol=1e-5)
    assert close.mean() > 0.99, close.mean()
    np.testing.assert_allclose(out_t.numpy(), exp, rtol=2e-3, atol=2e-3)
    # ... while the same scan without the roundings misses most elements
    unrounded = ref.ssm_scan_chunked_ref(*(t.to(torch.float32) for t in args), chunk=chunk)
    assert np.isclose(unrounded.numpy(), exp, rtol=1e-5, atol=1e-5).mean() < 0.5


@pytest.mark.parametrize("bh,l,p,n", [(2, 128, 16, 8), (4, 256, 32, 16), (8, 128, 8, 4),
                                      (3, 97, 8, 4), (2, 24, 1, 16)])
@pytest.mark.parametrize("bf16", [False, True])
def test_ssm_scan_wrapper_matches_the_pallas_kernel(bh, l, p, n, bf16):
    """The wrapper on CPU tensors (the sequential oracle) against the Pallas
    kernel in interpret mode, in the reference tests' decay range, with a
    ragged chunk (97), P = 1 and bf16 x, b, c (both sides scan in f32 from the
    same bf16 values)."""
    x, a, b, c = _ssm_inputs(_rng(bh, l, p, n, 1), bh, l, p, n)
    bf = torch.bfloat16 if bf16 else None
    out_t = ssm_scan(_t(x, bf), _t(a), _t(b, bf), _t(c, bf))
    kernel = j_ssm_scan(_j(x, bf16), _j(a), _j(b, bf16), _j(c, bf16), interpret=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(kernel), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("decay", [(0.3, 0.6), (0.05, 0.35)])
def test_ssm_scan_strong_decay_matches_the_sequential_oracle(decay):
    """Strong decay: the reference's Pallas kernel forms the decay as a ratio
    of cumulative products, which underflows here, so the port is held to the
    sequential oracle alone; its chunked plain version stays exact too."""
    bh, l, p, n = 2, 128, 8, 4
    x, a, b, c = _ssm_inputs(_rng(int(decay[0] * 100)), bh, l, p, n, decay)
    exp = np.asarray(jref.ssm_scan_ref(_j(x), _j(a), _j(b), _j(c)))
    out_t = ssm_scan(_t(x), _t(a), _t(b), _t(c))
    np.testing.assert_allclose(out_t.numpy(), exp, rtol=2e-4, atol=2e-4)
    chunked = ref.ssm_scan_chunked_ref(_t(x), _t(a), _t(b), _t(c))
    np.testing.assert_allclose(chunked.numpy(), exp, rtol=2e-4, atol=2e-4)


def test_ssm_scan_wrapper_rejects_bad_inputs():
    x, a, b = torch.zeros(2, 16, 4), torch.zeros(2, 16), torch.zeros(2, 16, 8)
    with pytest.raises(ValueError):
        ssm_scan(x, a, b, torch.zeros(2, 16, 4))               # c differs from b
    with pytest.raises(ValueError):
        ssm_scan(x, torch.zeros(2, 15), b, b)                  # a too short
    with pytest.raises(ValueError):
        ssm_scan(x[:, :, 0], a, b, b)                          # x not 3-d
    with pytest.raises(TypeError):
        ssm_scan(x, a.to(torch.bfloat16), b, b)                # a must be f32
    with pytest.raises(TypeError):
        ssm_scan(x.to(torch.float16), a, b, b)


@pytest.mark.parametrize("l,use_kernel,expect", [
    (128, True, True), (24, True, True), (97, True, True), (256, True, True),
    (4, True, False), (200, True, True), (1, True, False), (128, False, False)])
def test_ssm_dispatch_predicate(l, use_kernel, expect):
    """Every L >= 8 takes the kernel: where L does not tile into 128-step
    chunks (200) the reference runs its sequential oracle, the kernel's own
    function; shorter lengths keep the chunked form's bf16 rounding."""
    assert ops.uses_ssm_kernel(l, use_kernel) == expect


@pytest.mark.parametrize("l,use_kernel", [(128, True), (48, True), (96, False), (200, True)])
def test_ops_ssm_forward_and_gradients(l, use_kernel):
    """Both sides of the predicate; the backward differentiates the chunked
    plain version, as the reference's VJP does."""
    bh, p, n = 2, 8, 4
    x, a, b, c = _ssm_inputs(_rng(l, 3), bh, l, p, n)
    g = _rng(l, 4).standard_normal((bh, l, p)).astype(np.float32)
    ts = [_t(v).requires_grad_(True) for v in (x, a, b, c)]
    out_t = ops.ssm(*ts, use_kernel)
    (out_t * _t(g)).sum().backward()

    def f(*args):
        return jops.ssm(*args, use_kernel)
    out_j = f(_j(x), _j(a), _j(b), _j(c))
    grads_j = jax.grad(lambda *t: jnp.sum(f(*t) * _j(g)), argnums=(0, 1, 2, 3))(
        _j(x), _j(a), _j(b), _j(c))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=2e-4, atol=2e-4)
    for t, gj in zip(ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("l,use_kernel", [(128, True), (97, True), (4, True), (64, False)])
@pytest.mark.parametrize("heads", [4, 1])
def test_ops_ssm_grouped_form_equals_the_repeated_form(l, use_kernel, heads):
    """b and c (G,L,N) shared by `heads` heads each give the output and all
    four gradients of the same b and c repeated per head (the reference's
    layout), on both sides of the predicate; the repeated form is held to
    the reference's `ops.ssm` by test_ops_ssm_forward_and_gradients."""
    groups, p, n = 2, 8, 4
    bh = groups * heads
    r = _rng(l, heads, 5)
    x, a, _, _ = _ssm_inputs(r, bh, l, p, n)
    b = (r.standard_normal((groups, l, n)) * 0.3).astype(np.float32)
    c = (r.standard_normal((groups, l, n)) * 0.3).astype(np.float32)
    g = r.standard_normal((bh, l, p)).astype(np.float32)
    grouped = [_t(v).requires_grad_(True) for v in (x, a, b, c)]
    repeated = [_t(v).requires_grad_(True) for v in
                (x, a, np.repeat(b, heads, axis=0), np.repeat(c, heads, axis=0))]
    outs = []
    for ts in (grouped, repeated):
        out = ops.ssm(*ts, use_kernel)
        (out * _t(g)).sum().backward()
        outs.append(out.detach().numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-6)
    for tg, tr in zip(grouped[:2], repeated[:2]):
        np.testing.assert_allclose(tg.grad.numpy(), tr.grad.numpy(), rtol=1e-5, atol=1e-6)
    for tg, tr in zip(grouped[2:], repeated[2:]):     # a group's gradient sums its heads'
        summed = tr.grad.numpy().reshape(groups, heads, l, n).sum(axis=1)
        np.testing.assert_allclose(tg.grad.numpy(), summed, rtol=1e-5, atol=1e-5)


def test_ssm_scan_wrapper_grouped_form_and_bad_groups():
    """The wrapper's grouped form equals the per-head form on the CPU, and a
    group count that does not divide BH is refused."""
    r = _rng(7)
    x, a, _, _ = _ssm_inputs(r, 6, 24, 4, 8)
    b = (r.standard_normal((3, 24, 8)) * 0.3).astype(np.float32)
    c = (r.standard_normal((3, 24, 8)) * 0.3).astype(np.float32)
    out = ssm_scan(_t(x), _t(a), _t(b), _t(c))
    want = ref.ssm_scan_ref(_t(x), _t(a), _t(np.repeat(b, 2, axis=0)),
                            _t(np.repeat(c, 2, axis=0)))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=0)
    with pytest.raises(ValueError):
        ssm_scan(_t(x), _t(a), torch.zeros(4, 24, 8), torch.zeros(4, 24, 8))   # 4 for 6 heads


# the scan shapes of the serving paths (chip_smoke.SSM_PATH: BH, L, P, N,
# dtypes of x, b, c, groups) and ragged ones
SSM_PLAN_SHAPES = [
    (8192, 128, 64, 64, ("bf16",) * 3, 128), (64, 97, 64, 64, ("bf16",) * 3, 1),
    (64, 4096, 64, 64, ("bf16",) * 3, 1), (512, 128, 256, 256, ("bf16",) * 3, 512),
    (512, 128, 1, 256, ("f32", "bf16", "bf16"), 512),
    (2, 128, 8, 4, ("f32",) * 3, 2), (2, 100, 5, 100, ("bf16", "f32", "bf16"), 2),
    (16384, 97, 40, 64, ("f32", "bf16", "bf16"), 16384), (2048, 64, 100, 256, ("bf16",) * 3, 2048),
    (64, 130, 32, 48, ("f32",) * 3, 16), (3, 24, 1, 64, ("f32", "bf16", "bf16"), 3),
    (4, 200, 64, 64, ("bf16",) * 3, 1), (64, 4000, 64, 64, ("bf16",) * 3, 1),
    (8, 1000, 1, 256, ("f32", "bf16", "bf16"), 8), (8, 2048, 1, 256, ("f32", "bf16", "bf16"), 8)]


def _ring_rows_covered(plan, bh, p):
    """How often `ssm_scan_kernel_ring` on `plan` writes each (bh, row), from
    the kernel's own map: block (bx, by), thread t -> head bx, rows p0 +
    (t / r) * rt .. + rt, written where the row is below P."""
    count = np.zeros((bh, p), np.int64)
    t = np.arange(plan.threads)
    row0 = (t // plan.r) * plan.rt
    only_part0 = t % plan.r == 0           # the R threads of a row write it once
    for bx in range(bh):
        for by in range(plan.row_tiles):
            for k in range(plan.rt):
                rows = by * plan.rows + row0 + k
                ok = only_part0 & (rows < p) & (row0 + k < min(plan.rows, p - by * plan.rows))
                np.add.at(count, (np.full(ok.sum(), bx), rows[ok]), 1)
    return count


@pytest.mark.parametrize("bh,l,p,n,dts,groups", SSM_PLAN_SHAPES)
def test_ssm_plan_covers_every_row_and_step_once(bh, l, p, n, dts, groups):
    from repro_torch.kernels import ssm_scan as SS
    plan = SS.ssm_plan(bh, groups, l, p, n, dts)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= SS.THREADS
    assert (plan.rt, plan.ns) in SS.RING_VARIANTS and plan.r * plan.ns >= n
    assert plan.threads == plan.r * plan.rows // plan.rt       # one head a block
    assert plan.smem == SS.ring_smem(plan.rt, plan.ns, plan.r, plan.rows, plan.row_tiles,
                                     p, n, plan.t_tile, dts)
    assert plan.smem <= SS.SMEM_PER_BLOCK
    np.testing.assert_array_equal(_ring_rows_covered(plan, min(bh, 4), p), 1)
    # chunk z covers [z*chunk, min(L, (z+1)*chunk)) in tiles of t_tile steps
    assert plan.chunk % plan.t_tile == 0 and plan.chunks == -(-l // plan.chunk)
    steps = np.zeros(l, np.int64)
    for z in range(plan.chunks):
        ts, te = z * plan.chunk, min(l, (z + 1) * plan.chunk)
        for k in range(-(-(te - ts) // plan.t_tile)):
            steps[ts + k * plan.t_tile:min(te, ts + (k + 1) * plan.t_tile)] += 1
    np.testing.assert_array_equal(steps, 1)


def _two_pass_scan(x, a, b, c, chunk):
    """The chunk-parallel scan as the kernels compute it, in torch: pass 1
    scans each chunk from a zero state step by step (local y, the chunk's
    final state S_k, and w_t, the product of decays from the chunk's start
    formed step by step forward); the carry walks the chunks in order,
    S_in(k+1) = A_k S_in(k) + S_k with A_k the chunk's last w; pass 2 adds
    w_t (S_in(k) c_t).  No ratio of decays anywhere."""
    bh, l, p = x.shape
    y = torch.empty((bh, l, p))
    w = torch.empty((bh, l))
    finals = []
    for ts in range(0, l, chunk):
        te = min(l, ts + chunk)
        s = torch.zeros((bh, p, b.shape[-1]))
        prod = torch.ones(bh)
        for t in range(ts, te):
            s = a[:, t, None, None] * s + x[:, t, :, None] * b[:, t, None, :]
            y[:, t] = torch.einsum("zpn,zn->zp", s, c[:, t])
            prod = prod * a[:, t]
            w[:, t] = prod
        finals.append((s, w[:, te - 1]))
    s_in = torch.zeros_like(finals[0][0])
    for k, ts in enumerate(range(0, l, chunk)):
        te = min(l, ts + chunk)
        if k:
            y[:, ts:te] += w[:, ts:te, None] * torch.einsum("zpn,ztn->ztp", s_in, c[:, ts:te])
        s_in = finals[k][1][:, None, None] * s_in + finals[k][0]
    return y


@pytest.mark.parametrize("decay", [(0.68, 0.98), (0.3, 0.6), (0.05, 0.35)])
@pytest.mark.parametrize("l,chunk", [(512, 128), (300, 64)])      # 300: a ragged last chunk
def test_two_pass_carry_matches_the_sequential_oracle(decay, l, chunk):
    """The chunk-parallel scheme of `ssm_scan_kernel_carry` and
    `ssm_scan_kernel_carry_out` holds the sequential oracle at the kernel's
    tolerance, at strong decay too, where the products of decays across a
    chunk underflow to 0 (which is then the right answer)."""
    bh, p, n = 3, 8, 16
    x, a, b, c = (_t(v) for v in _ssm_inputs(_rng(l, int(decay[0] * 100)), bh, l, p, n, decay))
    want = jref.ssm_scan_ref(*(_j(v.numpy()) for v in (x, a, b, c)))
    np.testing.assert_allclose(_two_pass_scan(x, a, b, c, chunk).numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_ssm_plan_chunks_only_small_long_scans():
    """Chunk-parallel at zamba2's 4096-token prefill at batch 1 and 2 (8
    chunks of 512), not from batch 4 on (the state past 2^19 entries), not
    at batch 128, not at a short B=1 prefill; a ragged last chunk."""
    from repro_torch.kernels import ssm_scan as SS
    assert (SS.ssm_plan(64, 1, 4096, 64, 64).chunks, SS.ssm_plan(64, 1, 4096, 64, 64).chunk) == (8, 512)
    assert SS.ssm_plan(128, 2, 4096, 64, 64).chunks == 8
    assert SS.ssm_plan(256, 4, 4096, 64, 64).chunks == 1
    assert SS.ssm_plan(64, 1, 4000, 64, 64).chunks == 8
    assert SS.ssm_plan(64, 1, 1024, 64, 64).chunks == 1
    assert SS.ssm_plan(8192, 128, 128, 64, 64).chunks == 1
    assert SS.ssm_plan(64, 1, 97, 64, 64).chunks == 1
    assert SS.ssm_plan(8192, 128, 4096, 64, 64).chunks == 1


@pytest.mark.parametrize("bh,l,p,n,dts,groups,rt,ns,rows,t_tile", [
    (8192, 128, 64, 64, ("bf16",) * 3, 128, 4, 16, 64, 8),       # zamba2 B=128
    (512, 128, 256, 256, ("bf16",) * 3, 512, 4, 16, 64, 8),      # xlstm B=128
    (64, 97, 64, 64, ("bf16",) * 3, 1, 1, 8, 32, 32),            # zamba2 B=1: one wave
    (64, 4096, 64, 64, ("bf16",) * 3, 1, 4, 16, 64, 16),         # ... chunk-parallel
    (512, 128, 1, 256, ("f32", "bf16", "bf16"), 512, 1, 8, 1, 16)])   # the normaliser
def test_ssm_plan_rule_at_the_serving_shapes(bh, l, p, n, dts, groups, rt, ns, rows, t_tile):
    """Wide grids (counting chunks): four rows of 16 entries a thread, at
    least two blocks an SM.  Narrow ones: one row of 8 entries a thread.
    The longest time tile that keeps one wave."""
    from repro_torch.kernels import ssm_scan as SS
    plan = SS.ssm_plan(bh, groups, l, p, n, dts)
    assert (plan.rt, plan.ns, plan.rows, plan.t_tile) == (rt, ns, rows, t_tile)
    if plan.blocks > SS.SMS:
        assert 2 * (plan.smem + 1024) <= SS.SMEM_PER_SM


# ---------------------------------------------------------------------------
# photonic MAC: the tensor-core kernel's plan, dispatch and int8 fragments
# ---------------------------------------------------------------------------

# (K, N) of every linear that reaches the kernel on the serving paths:
# yi-6b (wq/wo, wk/wv, wg/wi, mlp wo, lm_head), zamba2 (out_proj, shared
# attention, head), xlstm (wqkv, wo, sLSTM wx, tied head), mixtral and
# seamless (wk/wv and mlp wo; seamless's others are xlstm's), qwen2-vl
# (wq/wo, wk/wv, wg/wi, mlp wo, lm_head); yi-34b, deepseek-67b (its wq/wo
# and wk/wv are qwen2-vl's), gemma3-27b (wq, wk/wv, wo, wg/wi, mlp wo, the
# tied head) and grok-1 (wq/wo, wk/wv, head; its experts are plain products)
MAIN_PATH_KN = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096), (4096, 64000),
                (4096, 2048), (2048, 2048), (2048, 32000),
                (1024, 3072), (1024, 1024), (1024, 4096), (1024, 50304),
                (4096, 1024),
                (8192, 8192), (8192, 1024), (8192, 29568), (29568, 8192), (8192, 152064),
                (7168, 7168), (7168, 1024), (7168, 20480), (20480, 7168), (7168, 64000),
                (8192, 22016), (22016, 8192), (8192, 102400),
                (5376, 4096), (5376, 2048), (4096, 5376), (5376, 21504), (21504, 5376),
                (5376, 262144),
                (6144, 6144), (6144, 1024), (6144, 131072)]


@pytest.mark.parametrize("k,n", MAIN_PATH_KN)
def test_mac_plan_k_ranges_do_not_depend_on_m(k, n):
    """The split of K, and so every output's order of summation, is the same
    at every M: the kernel cuts K into `splits` runs of whole banks from K
    and `splits` alone, and sums them in range order whichever way the plan
    spreads them over blocks."""
    plans = [mac_plan(m, k, n) for m in (1, 100, 128, 512, 16384)]
    for p in plans:
        assert p.splits == plans[0].splits == mac_splits(k, n)
        assert p.cluster in (1, p.splits) and p.m_tiles * p.bm >= 1 and p.n_tiles == n // 128
    assert 1 <= plans[0].splits <= min(16, k // 128)


@pytest.mark.parametrize("k,n", MAIN_PATH_KN)
def test_mac_ranges_cover_every_bank_once(k, n):
    """The kernel's K ranges (`mac_ranges`, the formula of
    `mac_kernel_sm90`) tile the banks in order, each bank once, none
    empty, and differ by at most one bank."""
    splits = mac_splits(k, n)
    ranges = mac_ranges(k, splits)
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == k // 128
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [hi - lo for lo, hi in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("k,n,sizes", [
    (5376, 2048, [10, 11, 10, 11]),      # gemma3's wk/wv: 42 banks over 4, uneven
    (7168, 1024, [7] * 8),               # yi-34b's wk/wv: 56 banks over 8
    (6144, 1024, [6] * 8),               # grok-1's wk/wv: 48 banks over 8
    (4096, 512, [2] * 16), (11008, 4096, [43, 43])])
def test_mac_ranges_at_the_serving_splits(k, n, sizes):
    """The range lengths the serving paths' split products sum."""
    assert [hi - lo for lo, hi in mac_ranges(k, mac_splits(k, n))] == sizes


@pytest.mark.parametrize("k,n", MAIN_PATH_KN)
def test_mac_plan_fills_the_card_at_128_rows(k, n):
    """At 128 rows (a batch-128 decode step) every main-path product puts at
    least one block on each of the H100's 132 SMs."""
    p = mac_plan(128, k, n)
    assert p.blocks >= 132
    assert p.bm in (32, 64, 128) and p.m_tiles == -(-128 // p.bm)


@pytest.mark.parametrize("k,n", MAIN_PATH_KN)
def test_mac_plan_sums_ranges_in_turn_at_large_m(k, n):
    """In the batch-128 prefill (16384 rows) 128-row tiles alone fill the
    card, so a split's ranges are summed in turn by each block (cluster of
    1) and the grid is no larger than the unsplit one; at 128 rows a split
    is spread over a cluster of that many blocks."""
    big, small = mac_plan(16384, k, n), mac_plan(128, k, n)
    assert (big.bm, big.cluster, big.m_tiles) == (128, 1, 128)
    assert big.blocks == 128 * (n // 128)
    assert small.cluster == small.splits


@pytest.mark.parametrize("m,k,n,m_fast", [
    (128, 4096, 11008, True), (512, 4096, 64000, True), (1024, 4096, 4096, True),
    (16384, 4096, 11008, False), (1100, 1024, 1024, False), (256, 4096, 512, True)])
def test_mac_plan_grid_order(m, k, n, m_fast):
    """Row tiles fastest in the grid up to 8 of them, column tiles beyond."""
    p = mac_plan(m, k, n)
    assert p.m_fast == m_fast and (p.m_tiles <= 8) == m_fast


@pytest.mark.parametrize("m,k,n,cluster", [
    (512, 4096, 512, 16), (512, 4096, 4096, 1), (256, 4096, 4096, 2), (1024, 1024, 1024, 8),
    (2048, 1024, 1024, 1)])
def test_mac_plan_clusters_only_where_row_tiles_leave_sms_idle(m, k, n, cluster):
    """The cluster split is taken below SEQ_BLOCKS unsplit 128-row blocks."""
    p = mac_plan(m, k, n)
    assert p.cluster == cluster
    assert (-(-m // 128) * (n // 128) >= SEQ_BLOCKS) == (cluster == 1)


@pytest.mark.parametrize("m,k,n", [(128, 200, 256), (128, 256, 300), (0, 128, 128)])
def test_mac_plan_rejects_what_the_kernel_cannot_take(m, k, n):
    with pytest.raises(ValueError):
        mac_plan(m, k, n)


def test_dispatch_routes_only_bank_aligned_bf16_to_the_tensor_core_kernel():
    bf, f32 = torch.bfloat16, torch.float32
    wq = torch.zeros(256, 384, dtype=torch.int8)
    assert dispatch(torch.zeros(5, 256, dtype=bf), wq)[0] == "mac_kernel_sm90"
    assert dispatch(torch.zeros(5, 256, dtype=bf), wq)[1] == mac_plan(5, 256, 384)
    assert dispatch(torch.zeros(5, 256, dtype=f32), wq) == ("mac_kernel", None)
    assert dispatch(torch.zeros(5, 256, dtype=bf), wq, tensor_cores=False) == ("mac_kernel", None)
    assert dispatch(torch.zeros(5, 136, dtype=bf), torch.zeros(136, 384, dtype=torch.int8)) == (
        "mac_kernel", None)
    assert dispatch(torch.zeros(5, 256, dtype=bf), torch.zeros(256, 144, dtype=torch.int8)) == (
        "mac_kernel", None)
    shifted = torch.zeros(5 * 256 + 8, dtype=bf)[8:].view(5, 256)    # 16 bytes in: aligned
    assert dispatch(shifted, wq)[0] == "mac_kernel_sm90"
    shifted = torch.zeros(5 * 256 + 1, dtype=bf)[1:].view(5, 256)    # 2 bytes in: not
    assert dispatch(shifted, wq) == ("mac_kernel", None)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm (selector nibbles 0-7 pick bytes of y:x)."""
    src = (int(y) << 32) | int(x)
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _i8x4_to_bf16x2(r):
    """`i8x4_to_bf16x2` of csrc/mma.cuh, step by step in f32: returns the
    (even, odd) bf16x2 bit patterns."""
    u = r ^ 0x80808080
    f = [np.array([_byte_perm(u, 0x4B000000, sel)], np.uint32).view(np.float32)[0]
         - np.float32(8388736.0) for sel in (0x7650, 0x7651, 0x7652, 0x7653)]
    bits = [int(np.array([v], np.float32).view(np.uint32)[0]) for v in f]   # e0, o0, e1, o1
    return _byte_perm(bits[0], bits[2], 0x7632), _byte_perm(bits[1], bits[3], 0x7632)


def _bf16_pair(reg):
    """The two bf16 halves of a register as floats, low half first."""
    return [float(np.array([((reg >> s) & 0xFFFF) << 16], np.uint32).view(np.float32)[0])
            for s in (0, 16)]


def test_int8_levels_widen_to_bf16_exactly():
    """Every int8 level (and -128) comes out of the byte-permute and bias
    conversion as itself, in the halves the kernel expects."""
    levels = np.arange(-128, 128, dtype=np.int8)
    for quad in levels.reshape(-1, 4):
        r = int(quad.view(np.uint32)[0])
        even, odd = _i8x4_to_bf16x2(r)
        assert _bf16_pair(even) == [float(quad[0]), float(quad[2])]
        assert _bf16_pair(odd) == [float(quad[1]), float(quad[3])]


def test_int8_fragments_reassemble_the_product():
    """The tensor-core kernel's path for one warp and one 32-deep step, in
    numpy: `ldmatrix.trans` of the raw int8 [k][n] slice read as b16 pairs,
    the widening into the A fragments of two 16-deep wgmma products (A row g
    = weight column 2g, row g+8 = column 2g+1; B = x transposed), and the
    store of the D fragment.  What the store writes must be x @ w."""
    r = _rng(21)
    x = r.standard_normal((8, 32)).astype(np.float32)                 # 8 rows of x, 32 deep
    w = r.integers(-127, 128, size=(32, 16)).astype(np.int8)         # [k][n], one warp's columns
    b16 = np.ascontiguousarray(w).view(np.uint16)                     # [32][8] column pairs
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    d = np.zeros((16, 8))                                             # D: (A row, x row)
    frags = {}
    for g, t in lanes:
        # ldmatrix.x4.trans: lane l addresses K row l, so matrix j is K rows 8j..8j+7
        regs = [int(b16[8 * j + 2 * t, g]) | int(b16[8 * j + 2 * t + 1, g]) << 16 for j in range(4)]
        pairs = [_i8x4_to_bf16x2(v) for v in regs]                    # (even, odd) of each
        frags[g, t] = [[pairs[0][0], pairs[0][1], pairs[1][0], pairs[1][1]],
                       [pairs[2][0], pairs[2][1], pairs[3][0], pairs[3][1]]]
    for h in range(2):                                                # the two 16-deep products
        a = np.zeros((16, 16))
        for (g, t), fr in frags.items():
            a0, a1, a2, a3 = fr[h]
            a[g, 2 * t:2 * t + 2] = _bf16_pair(a0)
            a[g + 8, 2 * t:2 * t + 2] = _bf16_pair(a1)
            a[g, 2 * t + 8:2 * t + 10] = _bf16_pair(a2)
            a[g + 8, 2 * t + 8:2 * t + 10] = _bf16_pair(a3)
        d += a @ x[:, 16 * h:16 * h + 16].astype(np.float64).T
    out = np.full((8, 16), np.nan)
    for g, t in lanes:
        acc = (d[g, 2 * t], d[g, 2 * t + 1], d[g + 8, 2 * t], d[g + 8, 2 * t + 1])
        for e in range(2):                                            # x rows 2t, 2t+1
            out[2 * t + e, 2 * g:2 * g + 2] = (acc[e], acc[2 + e])
    np.testing.assert_allclose(out, x.astype(np.float64) @ w.astype(np.float64),
                               rtol=1e-12, atol=1e-9)


# ---------------------------------------------------------------------------
# flash attention: the tensor-core kernel's plan and dispatch
# ---------------------------------------------------------------------------

# (b, hq, hk, sq, sk, d, causal, window, q_offset): the prefills of the
# serving paths (yi-6b: 32/4 heads of 128; zamba2's shared attention: 32/32
# heads of 64, window 4096), then ragged and offset shapes, rows masked
# everywhere, and no mask
ATTN_PLAN_SHAPES = [
    (1, 32, 4, 128, 128, 128, True, 0, 0), (1, 32, 4, 256, 256, 128, True, 0, 0),
    (1, 32, 4, 512, 512, 128, True, 0, 0), (128, 32, 4, 128, 128, 128, True, 0, 0),
    (1, 32, 32, 4096, 4096, 64, True, 4096, 0), (128, 32, 32, 128, 128, 64, True, 4096, 0),
    (1, 32, 32, 1024, 1024, 64, True, 4096, 0), (1, 32, 4, 97, 97, 128, True, 0, 0),
    (2, 4, 2, 40, 40, 64, True, 0, 0), (2, 4, 2, 100, 100, 128, True, 24, 0),
    (1, 8, 4, 200, 200, 64, True, 0, 0), (1, 16, 2, 128, 384, 128, True, 64, 256),
    (1, 16, 2, 128, 384, 64, True, 100, 256), (2, 4, 2, 128, 100, 64, True, 0, 64),
    (2, 4, 2, 128, 100, 128, True, 32, 64), (1, 2, 2, 64, 64, 64, True, 16, 128),
    (1, 4, 4, 200, 200, 128, False, 0, 0), (1, 4, 4, 300, 300, 64, False, 50, 0),
    (1, 4, 4, 300, 260, 64, False, 50, 10), (1, 4, 2, 200, 150, 128, True, 0, 0),
]


def _kv_range(q0, sq, sk, causal, window, q_offset, skip):
    """`kv_range` of csrc/flash_attention.cu: [begin, end) of the keys the
    block of query rows [q0, q0 + BQ) visits, in whole tiles of BKV keys
    from `begin`."""
    if not skip:
        return 0, sk
    begin, end = 0, sk
    if causal:
        end = min(sk, q_offset + min(q0 + FA.BQ, sq))
    if window > 0:
        lo = q_offset + q0 - window + 1
        if lo > 0:
            begin = (lo // FA.BKV) * FA.BKV
    return begin, end


def _block(plan, index, bh_count):
    """(batch * Hq + head, first query row) of grid block `index`, as
    `attn_kernel_sm90` computes them."""
    if plan.heavy_first:
        return index % bh_count, (plan.q_tiles - 1 - index // bh_count) * FA.BQ
    return index // plan.q_tiles, (index % plan.q_tiles) * FA.BQ


def _visible(sq, sk, causal, window, q_offset):
    q_pos = q_offset + np.arange(sq)[:, None]
    k_pos = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), dtype=bool)
    if causal:
        vis &= k_pos <= q_pos
    if window > 0:
        vis &= k_pos > q_pos - window
    return vis


@pytest.mark.parametrize("b,hq,hk,sq,sk,d,causal,window,off", ATTN_PLAN_SHAPES)
def test_attn_plan_visits_every_visible_pair(b, hq, hk, sq, sk, d, causal, window, off):
    """Every block visits whole KV tiles from its range's start; the tiles it
    skips hold no visible (query, key) pair of its rows, so every visible
    pair lies in a visited tile.  Without skipping every tile is visited."""
    plan = FA.attn_plan(b, hq, hk, sq, sk, d, causal, window, off)
    assert plan.q_tiles == -(-sq // FA.BQ)
    vis = _visible(sq, sk, causal, window, off)
    for q0 in range(0, sq, FA.BQ):
        begin, end = _kv_range(q0, sq, sk, causal, window, off, plan.skip)
        assert begin % FA.BKV == 0 and 0 <= begin < end <= sk
        visited = np.zeros(sk, dtype=bool)
        visited[begin:begin + -(-(end - begin) // FA.BKV) * FA.BKV] = True
        assert not vis[q0:q0 + FA.BQ][:, ~visited].any()
        if not plan.skip:
            assert visited.all()


@pytest.mark.parametrize("b,hq,hk,sq,sk,d,causal,window,off", ATTN_PLAN_SHAPES)
def test_attn_plan_skips_exactly_when_no_row_is_masked_everywhere(b, hq, hk, sq, sk, d, causal,
                                                                  window, off):
    """With a mask, `skip` is 0 exactly when some query row sees no key
    (it must then average V over every key); without one nothing is
    skipped."""
    plan = FA.attn_plan(b, hq, hk, sq, sk, d, causal, window, off)
    fully_masked = (~_visible(sq, sk, causal, window, off).any(axis=1)).any()
    if causal or window > 0:
        assert plan.skip == (not fully_masked)
    else:
        assert not plan.skip and not fully_masked


@pytest.mark.parametrize("b,hq,hk,sq,sk,d,causal,window,off", ATTN_PLAN_SHAPES)
def test_attn_plan_grid_covers_every_query_row_once(b, hq, hk, sq, sk, d, causal, window, off):
    """The grid's blocks, mapped to (batch * head, query tile) as the kernel
    maps them, cover every query row of every head once; with `heavy_first`
    the blocks with the most KV tiles come first."""
    plan = FA.attn_plan(b, hq, hk, sq, sk, d, causal, window, off)
    assert plan.blocks == b * hq * plan.q_tiles
    seen = np.zeros((b * hq, sq), dtype=np.int64)
    work = []
    for i in range(plan.blocks):
        bh, q0 = _block(plan, i, b * hq)
        assert q0 % FA.BQ == 0
        seen[bh, q0:q0 + FA.BQ] += 1
        begin, end = _kv_range(q0, sq, sk, causal, window, off, plan.skip)
        work.append(-(-(end - begin) // FA.BKV))
    assert (seen == 1).all()
    if plan.heavy_first:
        assert work == sorted(work, reverse=True)
    assert plan.heavy_first == (causal and plan.skip and plan.q_tiles > 2)


@pytest.mark.parametrize("b,hq,sq,window,off,heavy_first", [
    (1, 32, 128, 0, 0, False), (1, 32, 256, 0, 0, True), (1, 32, 512, 0, 0, True),
    (128, 32, 128, 0, 0, False), (1, 32, 4096, 4096, 0, True), (128, 32, 128, 4096, 0, False),
    (1, 4, 200, 0, 0, True), (1, 4, 192, 16, 500, False)])
def test_attn_plan_grid_order(b, hq, sq, window, off, heavy_first):
    """64-row query tiles everywhere; the longest query tiles first where a
    causal mask gives more than two of them unequal work (not with rows
    masked everywhere, where every block visits every tile)."""
    plan = FA.attn_plan(b, hq, hq, sq, sq if off == 0 else 64, 128, True, window, off)
    assert plan.heavy_first == heavy_first


@pytest.mark.parametrize("shape", [(1, 4, 128, 96), (0, 4, 128, 128), (1, 3, 128, 128)])
def test_attn_plan_rejects_what_the_kernel_cannot_take(shape):
    b, hq, sq, d = shape
    with pytest.raises(ValueError):
        FA.attn_plan(b, hq, 2, sq, sq, d)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_dispatch_routes_bf16_at_64_and_128_to_the_tensor_core_kernel(d, dtype):
    q = torch.zeros(2, 8, 128, d, dtype=dtype)
    k = torch.zeros(2, 2, 128, d, dtype=dtype)
    kernel, plan = FA.dispatch(q, k, k)
    if dtype == torch.bfloat16 and d in (64, 128):
        assert kernel == "attn_kernel_sm90"
        assert plan == FA.attn_plan(2, 8, 2, 128, 128, d)
    else:
        assert (kernel, plan) == ("attn_kernel", None)
    assert FA.dispatch(q, k, k, tensor_cores=False) == ("attn_kernel", None)


def test_attention_dispatch_takes_the_models_strided_views_and_refuses_odd_strides():
    bf = torch.bfloat16
    # (B,S,H,D) projections viewed as (B,H,S,D): every stride a multiple of 8
    q = torch.zeros(2, 128, 8, 128, dtype=bf).movedim(2, 1)
    k = torch.zeros(2, 128, 2, 128, dtype=bf).movedim(2, 1)
    kernel, plan = FA.dispatch(q, k, k, causal=True, window=0, q_offset=0)
    assert kernel == "attn_kernel_sm90" and plan.skip
    assert FA.dispatch(q, k, k, window=16, q_offset=200)[1] == FA.attn_plan(
        2, 8, 2, 128, 128, 128, True, 16, 200)
    # a head stride of 132 elements (rows padded by 4)
    odd = torch.zeros(2, 8, 128, 132, dtype=bf)[..., :128]
    assert odd.stride(3) == 1 and odd.stride(2) % 8 != 0
    assert FA.dispatch(odd, k, k) == ("attn_kernel", None)
    assert FA.dispatch(q, odd[:, :2], odd[:, :2]) == ("attn_kernel", None)
    # storage 2 bytes past a 16-byte boundary
    flat = torch.zeros(2 * 8 * 128 * 64 + 1, dtype=bf)[1:].view(2, 8, 128, 64)
    assert FA.dispatch(flat, flat[:, :2], flat[:, :2]) == ("attn_kernel", None)
    flat = torch.zeros(2 * 8 * 128 * 64 + 8, dtype=bf)[8:].view(2, 8, 128, 64)
    assert FA.dispatch(flat, flat[:, :2], flat[:, :2])[0] == "attn_kernel_sm90"


# ---------------------------------------------------------------------------
# flash attention: the tensor-core kernel's shared-memory layouts and
# fragments, emulated in numpy
# ---------------------------------------------------------------------------

def _sw_off(rows, r, c):
    """`sw_off` of csrc/flash_attention.cu: byte offset of 16-byte chunk c of
    row r in a tile of `rows` rows, stored as 64-wide panels of 128-byte
    rows in the 128-byte swizzle."""
    return (c // 8) * (rows * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4)


def _swizzled_tile(x):
    """The bytes `copy_tile` leaves in shared memory for a (rows, D) bf16
    tile x (as uint16 bit patterns)."""
    rows, d = x.shape
    img = np.zeros(rows * d, np.uint16)
    for r in range(rows):
        for c in range(d // 8):
            off = _sw_off(rows, r, c) // 2
            img[off:off + 8] = x[r, 8 * c:8 * c + 8]
    return img


def _swz128(byte_addr):
    """The 128-byte swizzle the tensor cores apply to a shared-memory address
    (1024-byte aligned atoms): bits 4-6 ^= bits 7-9."""
    return byte_addr ^ (((byte_addr >> 7) & 7) << 4)


def _k_major(img, start, rows):
    """A (rows x 16) operand read through `sw128_desc(start)`: 8-row atoms
    1024 bytes apart, each row's 16 values at start + 128 * row + 2 * k."""
    out = np.empty((rows, 16), np.uint16)
    for r in range(rows):
        for k in range(16):
            b = start + (r // 8) * 1024 + (r % 8) * 128 + 16 * (k // 8) + 2 * (k % 8)
            out[r, k] = img[_swz128(b) // 2]
    return out


def _mn_major(img, start, lbo, n):
    """A (16 x n) operand read MN-major through `sw128_mn_desc(start, lbo)`:
    canonical layout ((8, 8, n/64), (8, 2)) : ((1, 8, lbo), (64, sbo)) in
    elements, stride byte offset 1024."""
    out = np.empty((16, n), np.uint16)
    for k in range(16):
        for j in range(n):
            b = (start + 2 * (j % 8) + 16 * ((j // 8) % 8) + lbo * (j // 64)
                 + 128 * (k % 8) + 1024 * (k // 8))
            out[k, j] = img[_swz128(b) // 2]
    return out


def _bf16_bits(x):
    """float32 -> bf16 bit patterns, rounded to nearest even."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _bits_f32(b):
    return (b.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


@pytest.mark.parametrize("d", [64, 128])
def test_attn_q_k_tiles_give_q_kt_through_their_descriptors(d):
    """S = Q K^T as the kernel's wgmma sees it: Q (64 rows) and a K tile (64
    keys) copied into the swizzled layout, each 16-deep step read through
    `sw128_desc` at panel (step / 4), 32 * (step % 4) bytes along the row."""
    r = _rng(31, d)
    qb = _bf16_bits(r.standard_normal((64, d)))
    kb = _bf16_bits(r.standard_normal((64, d)))
    q_img, k_img = _swizzled_tile(qb), _swizzled_tile(kb)
    s = np.zeros((64, 64))
    for kk in range(d // 16):
        a = _k_major(q_img, (kk // 4) * (64 * 128) + (kk % 4) * 32, 64)
        b = _k_major(k_img, (kk // 4) * (64 * 128) + (kk % 4) * 32, 64)   # [key][k]
        s += _bits_f32(a) @ _bits_f32(b).T
    np.testing.assert_allclose(s, _bits_f32(qb) @ _bits_f32(kb).T, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("d", [64, 128])
def test_attn_p_fragments_and_mn_major_v_give_p_v(d):
    """O = P V as the kernel computes it for one warpgroup: the S fragment
    (thread (w, g, t): s[4j+e] = row 16w+g, key 8j+2t+e; s[4j+2+e] = row
    16w+g+8) packed into the A fragments `pa` of four 16-key steps, V read
    MN-major from the swizzled tile through `sw128_mn_desc` (16 keys = 2048
    bytes a step, 64-wide panels 64 * 128 bytes apart), and the store of the
    D fragment.  What the store writes must be P V."""
    r = _rng(37, d)
    p = r.random((64, 64))                                            # probabilities
    vb = _bf16_bits(r.standard_normal((64, d)))
    v_img = _swizzled_tile(vb)
    pa = {}
    for w in range(4):
        for g in range(8):
            for t in range(4):
                s = np.empty(32)
                for j in range(8):
                    for e in range(2):
                        s[4 * j + e] = p[16 * w + g, 8 * j + 2 * t + e]
                        s[4 * j + 2 + e] = p[16 * w + g + 8, 8 * j + 2 * t + e]
                pa[w, g, t] = [[_bf16_bits(s[8 * ks + 2 * i:8 * ks + 2 * i + 2]) for i in range(4)]
                               for ks in range(4)]
    o = np.zeros((64, d))
    for ks in range(4):
        a = np.empty((64, 16))                  # A of this step, from the lanes' registers
        for (w, g, t), regs in pa.items():
            a0, a1, a2, a3 = (_bits_f32(x) for x in regs[ks])
            a[16 * w + g, 2 * t:2 * t + 2] = a0
            a[16 * w + g + 8, 2 * t:2 * t + 2] = a1
            a[16 * w + g, 2 * t + 8:2 * t + 10] = a2
            a[16 * w + g + 8, 2 * t + 8:2 * t + 10] = a3
        b = _mn_major(v_img, ks * 16 * 128, 64 * 128, d)
        np.testing.assert_array_equal(b, vb[16 * ks:16 * ks + 16])
        o += a @ _bits_f32(b)
    out = np.full((64, d), np.nan)
    for w in range(4):
        for g in range(8):
            for t in range(4):
                frag = np.empty(d // 2)         # the D fragment wgmma leaves in the thread
                for j in range(d // 8):
                    for e in range(2):
                        frag[4 * j + e] = o[16 * w + g, 8 * j + 2 * t + e]
                        frag[4 * j + 2 + e] = o[16 * w + g + 8, 8 * j + 2 * t + e]
                for h in range(2):              # the store: o[4n+2h+e] -> (16w+g+8h, 8n+2t+e)
                    for n in range(d // 8):
                        out[16 * w + g + 8 * h, 8 * n + 2 * t:8 * n + 2 * t + 2] = \
                            frag[4 * n + 2 * h:4 * n + 2 * h + 2]
    pb = _bits_f32(_bf16_bits(p))
    np.testing.assert_allclose(out, pb @ _bits_f32(vb), rtol=1e-12, atol=1e-9)
