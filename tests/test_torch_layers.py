"""Parity of `repro_torch.models.layers` with `repro.models.layers` on the
CPU: the same numpy inputs and weights through both, in f32.

Tolerance 1e-5 (rtol and atol) unless stated: the two sides do the same f32
arithmetic and differ in summation order and in the libm behind exp, sin and
cos.  Blocks that end in a matmul over the model width use 1e-4, the bound
the model-level parity tests use for logits.
"""

import dataclasses

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# `repro.models` pulls in `repro.core`, whose power model imports
# `jax.experimental.enable_x64`; newer jax only has `jax.enable_x64`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from repro import configs as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_BLOCK = dict(rtol=1e-4, atol=1e-4)


def _rng(*seed):
    return np.random.default_rng(list(seed))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfgs(arch="yi_6b", **kw):
    return (dataclasses.replace(JC.get_reduced(arch), **kw),
            dataclasses.replace(C.get_reduced(arch), **kw))


def _attn_params(cfg, r):
    m, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {"wq": r.standard_normal((m, h, dh)) / np.sqrt(m),
         "wk": r.standard_normal((m, hk, dh)) / np.sqrt(m),
         "wv": r.standard_normal((m, hk, dh)) / np.sqrt(m),
         "wo": r.standard_normal((h, dh, m)) / np.sqrt(h * dh),
         "norm": 0.1 * r.standard_normal((m,))}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()})


def test_config_copies_agree():
    """The port keeps its own ModelConfig and config files; they must say
    what the reference's say."""
    assert C.ARCH_IDS == JC.ARCH_IDS and C.ALIASES == JC.ALIASES
    for arch in C.ARCH_IDS:
        assert dataclasses.asdict(C.get(arch)) == dataclasses.asdict(JC.get(arch))
        assert dataclasses.asdict(C.get_reduced(arch)) == dataclasses.asdict(JC.get_reduced(arch))
        assert C.get(arch).param_count() == JC.get(arch).param_count()


def test_rms_norm():
    r = _rng(0)
    x = r.standard_normal((2, 5, 64)).astype(np.float32)
    s = r.standard_normal((64,)).astype(np.float32)
    np.testing.assert_allclose(L.rms_norm(_t(x), _t(s)).numpy(),
                               np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(s))), **TOL)


@pytest.mark.parametrize("offset", [0, 1000])
def test_apply_rope(offset):
    jcfg, cfg = _cfgs()
    r = _rng(1, offset)
    x = r.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = (np.arange(7)[None, :] + np.array([[offset], [offset + 3]])).astype(np.int32)
    # angles reach 1e3 rad: f32 sin/cos argument reduction differs by ~1e-4 rad
    tol = TOL if offset == 0 else dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        L.apply_rope(cfg, _t(x), _t(pos)).numpy(),
        np.asarray(JL.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos))), **tol)


def test_apply_rope_rejects_mrope_streams():
    """Three position streams for a config without M-RoPE raise (the
    reference would broadcast them into a wrong shape)."""
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="without mrope"):
        L.apply_rope(cfg, torch.zeros(1, 2, 4, 16), torch.zeros(3, 1, 2, dtype=torch.int32))


@pytest.mark.parametrize("head_dim,sections", [(128, (22, 21, 21)), (16, (4, 2, 2)),
                                               (64, (12, 10, 10))])
def test_mrope_sections_split_as_the_reference(head_dim, sections):
    """t takes the remainder, h and w n // 3 rotary pairs each."""
    sect = L.mrope_sections(head_dim // 2)
    assert tuple(sect.count(i) for i in range(3)) == sections
    assert sect == sorted(sect)


@pytest.mark.parametrize("offset", [0, 1000])
def test_apply_rope_mrope_matches_reference(offset):
    """Distinct t/h/w streams (a 3 x 3 patch grid, then text), so each
    rotary section must read its own stream; rope_theta 100, so that at
    Dh = 16 the h and w sections turn by more than rounding over a 3 x 3
    grid."""
    jcfg, cfg = _cfgs("qwen2_vl_72b", rope_theta=100.0)
    r = _rng(12, offset)
    x = r.standard_normal((2, 13, 4, 16)).astype(np.float32)
    pos = np.empty((3, 2, 13), np.int32)
    pos[0, :, :9], pos[1, :, :9], pos[2, :, :9] = 0, np.arange(9) // 3, np.arange(9) % 3
    pos[:, :, 9:] = 3 + np.arange(4)
    pos[:, 1] += offset
    tol = TOL if offset == 0 else dict(rtol=2e-4, atol=2e-4)
    out = L.apply_rope(cfg, _t(x), _t(pos))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(JL.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos))), **tol)
    # a wrong split would read other streams for some pairs
    same = L.apply_rope(cfg, _t(x), _t(np.ascontiguousarray(pos[[0, 0, 0]])))
    assert float((out - same).abs().max()) > 1e-2


def test_apply_rope_mrope_equal_streams_is_standard_rope():
    """Equal streams give the standard RoPE, bit for bit."""
    _, cfg = _cfgs("qwen2_vl_72b")
    r = _rng(13)
    x = _t(r.standard_normal((2, 7, 4, 16)).astype(np.float32))
    pos = _t((np.arange(7)[None, :] + np.array([[0], [40]])).astype(np.int32))
    three = pos[None].expand(3, 2, 7)
    assert torch.equal(L.apply_rope(cfg, x, three), L.apply_rope(cfg, x, pos))


@pytest.mark.parametrize("photonic", [False, True])
@pytest.mark.parametrize("s,se", [(7, 5), (1, 9)])
def test_apply_cross_attention(photonic, s, se):
    """Queries from the normed decoder stream, keys and values from the
    encoder's output with no norm and no RoPE, no mask; Se != S, and the
    one-token decode step."""
    jcfg, cfg = _cfgs("seamless_m4t_medium", use_photonic_mac=photonic)
    r = _rng(11, s, se)
    pj, pt = _both(_attn_params(cfg, r))
    x = r.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    enc = r.standard_normal((2, se, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    out = L.apply_cross_attention(cfg, pt, _t(x), _t(enc))
    assert tuple(out.shape) == (2, s, cfg.d_model)
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(JL.apply_cross_attention(jcfg, pj, jnp.asarray(x), jnp.asarray(enc),
                                            jnp.asarray(pos))), **TOL_BLOCK)


@pytest.mark.parametrize("photonic", [False, True])
def test_linear(photonic):
    jcfg, cfg = _cfgs(use_photonic_mac=photonic)
    r = _rng(2)
    x = r.standard_normal((2, 9, 64)).astype(np.float32)
    w = r.standard_normal((64, 4, 16)).astype(np.float32)
    out = L.linear(cfg, _t(w), _t(x))
    assert tuple(out.shape) == (2, 9, 4, 16)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(JL.linear(jcfg, jnp.asarray(w), jnp.asarray(x))),
                               **TOL_BLOCK)


@pytest.mark.parametrize("photonic", [False, True])
def test_apply_mlp(photonic):
    jcfg, cfg = _cfgs(use_photonic_mac=photonic)
    r = _rng(3)
    m, f = cfg.d_model, cfg.d_ff
    p = {"wi": r.standard_normal((m, f)) / 8, "wg": r.standard_normal((m, f)) / 8,
         "wo": r.standard_normal((f, m)) / 11, "norm": 0.1 * r.standard_normal((m,))}
    pj, pt = _both({k: v.astype(np.float32) for k, v in p.items()})
    x = r.standard_normal((2, 6, m)).astype(np.float32)
    np.testing.assert_allclose(L.apply_mlp(cfg, pt, _t(x)).numpy(),
                               np.asarray(JL.apply_mlp(jcfg, pj, jnp.asarray(x))), **TOL_BLOCK)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("s", [24, 5])
def test_apply_attention_no_cache(window, s):
    jcfg, cfg = _cfgs()
    r = _rng(4, window, s)
    pj, pt = _both(_attn_params(cfg, r))
    x = r.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (2, s)).copy()
    out_t, c = L.apply_attention(cfg, pt, _t(x), _t(pos), window=window)
    out_j, _ = JL.apply_attention(jcfg, pj, jnp.asarray(x), jnp.asarray(pos), window=window)
    assert c is None
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL_BLOCK)


def _zero_cache(cfg, b, length):
    shape = (b, cfg.n_kv_heads, length, cfg.head_dim_)
    return np.zeros(shape, np.float32)


@pytest.mark.parametrize("s,wlen", [(12, 32), (40, 16), (16, 16)])
def test_apply_attention_prefill_short_of_and_beyond_the_window(s, wlen):
    """Prefill writes K/V at the front of a longer cache, or keeps the last
    `wlen` positions of a prompt that fills or overruns it."""
    jcfg, cfg = _cfgs()
    r = _rng(5, s, wlen)
    pj, pt = _both(_attn_params(cfg, r))
    x = r.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (2, s)).copy()
    window = wlen if wlen < 32 else 0
    z = _zero_cache(cfg, 2, wlen)
    out_t, ct = L.apply_attention(cfg, pt, _t(x), _t(pos), window=window,
                                  cache={"k": _t(z.copy()), "v": _t(z.copy())}, cache_pos=0)
    out_j, cj = JL.apply_attention(jcfg, pj, jnp.asarray(x), jnp.asarray(pos), window=window,
                                   cache={"k": jnp.asarray(z), "v": jnp.asarray(z)},
                                   cache_pos=jnp.int32(0))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL_BLOCK)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]), **TOL_BLOCK)


@pytest.mark.parametrize("pos", [3, 15, 16, 40, [2, 16, 30], [0, 5, 15]])
def test_apply_attention_rolling_decode(pos):
    """Single-step decode over a 16-long cache: below the window the new K/V
    land at `pos`; from the window on, that slot's cache rolls left by one.
    Scalar and per-slot (B,) positions."""
    jcfg, cfg = _cfgs()
    wlen, b = 16, 3
    r = _rng(6, *np.atleast_1d(pos))
    pj, pt = _both(_attn_params(cfg, r))
    x = r.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ck = r.standard_normal((b, cfg.n_kv_heads, wlen, cfg.head_dim_)).astype(np.float32)
    cv = r.standard_normal((b, cfg.n_kv_heads, wlen, cfg.head_dim_)).astype(np.float32)
    pos_np = np.asarray(pos, np.int32)
    positions = np.broadcast_to(pos_np.reshape(-1, 1), (b, 1)).astype(np.int32)
    out_t, ct = L.apply_attention(
        cfg, pt, _t(x), _t(positions), cache={"k": _t(ck.copy()), "v": _t(cv.copy())},
        cache_pos=torch.as_tensor(pos_np.astype(np.int64)), cache_pos_max=int(pos_np.max()))
    out_j, cj = JL.apply_attention(
        jcfg, pj, jnp.asarray(x), jnp.asarray(positions),
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, cache_pos=jnp.asarray(pos_np))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL_BLOCK)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]), **TOL_BLOCK)


@pytest.mark.parametrize("pos", [7, [3, 9]])
@pytest.mark.parametrize("window,sq", [(0, 1), (4, 1), (0, 3)])
def test_decode_attention(pos, window, sq):
    r = _rng(8, window, sq)
    q = r.standard_normal((2, 4, sq, 16)).astype(np.float32)
    k = r.standard_normal((2, 2, 12, 16)).astype(np.float32)
    v = r.standard_normal((2, 2, 12, 16)).astype(np.float32)
    pos_np = np.asarray(pos, np.int32)
    out_t = L.decode_attention(_t(q), _t(k), _t(v), torch.as_tensor(pos_np.astype(np.int64)),
                               window=window)
    out_j = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos_np), window=window)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


# ---------------------------------------------------------------------------
# recurrent blocks: Mamba2 (zamba2), mLSTM and sLSTM (xlstm)
# ---------------------------------------------------------------------------


def _np_tree(p):
    return {k: v.astype(np.float32) for k, v in p.items()}


def _mamba_params(cfg, r):
    m, din, n, hm = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return _np_tree({
        "in_proj": r.standard_normal((m, 2 * din + 2 * n + hm)) / np.sqrt(m),
        "conv": 0.05 * r.standard_normal((cfg.conv_width, din)),
        "A_log": np.log(0.5) + 0.3 * r.standard_normal((hm,)),
        "D": 1.0 + 0.1 * r.standard_normal((hm,)),
        "dt_bias": 0.2 * r.standard_normal((hm,)),
        "out_proj": r.standard_normal((din, m)) / np.sqrt(din),
        "norm": 0.1 * r.standard_normal((m,)),
        "gate_norm": 0.1 * r.standard_normal((din,))})


def _mlstm_params(cfg, r):
    m, din, h = cfg.d_model, cfg.n_heads * cfg.head_dim_, cfg.n_heads
    return _np_tree({
        "wqkv": r.standard_normal((m, 3 * din)) / np.sqrt(m),
        "wif": 0.1 * r.standard_normal((m, 2 * h)) / np.sqrt(m),
        "wo": r.standard_normal((din, m)) / np.sqrt(din),
        "norm": 0.1 * r.standard_normal((m,))})


def _slstm_params(cfg, r):
    m = cfg.d_model
    return _np_tree({
        "wx": r.standard_normal((m, 4 * m)) / np.sqrt(m),
        "wr": 0.5 * r.standard_normal((m, 4 * m)) / np.sqrt(m),
        "bias": 0.1 * r.standard_normal((4 * m,)),
        "wo": r.standard_normal((m, m)) / np.sqrt(m),
        "norm": 0.1 * r.standard_normal((m,))})


def _recurrent_caches(cfg, kind, b, r):
    """A non-trivial cache of one block (the decode regime starts from it)."""
    if kind == "mamba":
        return _np_tree({
            "state": 0.3 * r.standard_normal((b, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)),
            "conv": r.standard_normal((b, cfg.conv_width - 1, cfg.d_inner))})
    if kind == "mlstm":
        h, dh = cfg.n_heads, cfg.head_dim_
        return _np_tree({"C": 0.3 * r.standard_normal((b * h, dh, dh)),
                         "n": np.abs(r.standard_normal((b * h, 1, dh)))})
    m = cfg.d_model
    return _np_tree({"h": 0.3 * r.standard_normal((b, m)), "c": r.standard_normal((b, m)),
                     "n": 1.0 + np.abs(r.standard_normal((b, m))),
                     "m": r.standard_normal((b, m))})


def _zero_recurrent_cache(cache):
    out = {k: np.zeros_like(v) for k, v in cache.items()}
    if "m" in out:
        out["m"] -= 10.0
    return out


_RECURRENT = {
    "mamba": ("zamba2_1p2b", _mamba_params, L.apply_mamba, JL.apply_mamba),
    "mlstm": ("xlstm_350m", _mlstm_params, L.apply_mlstm, JL.apply_mlstm),
    "slstm": ("xlstm_350m", _slstm_params, L.apply_slstm, JL.apply_slstm),
}


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("l", [7, 1])
def test_causal_conv(state, l):
    r = _rng(20, int(state), l)
    x = r.standard_normal((2, l, 12)).astype(np.float32)
    w = r.standard_normal((4, 12)).astype(np.float32)
    st = r.standard_normal((2, 3, 12)).astype(np.float32) if state else None
    y_t, ns_t = L._causal_conv(_t(x), _t(w), None if st is None else _t(st))
    y_j, ns_j = JL._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(ns_t.numpy(), np.asarray(ns_j), **TOL)


@pytest.mark.parametrize("kind", list(_RECURRENT))
@pytest.mark.parametrize("regime", ["no_cache", "prefill", "decode"])
@pytest.mark.parametrize("photonic", [False, True])
def test_recurrent_blocks_match_reference(kind, regime, photonic):
    """Each recurrent block in its three regimes: the whole sequence without a
    cache, prefill into a zeroed cache (the final state is written in place),
    and one decode step from a non-trivial cache."""
    arch, make_params, apply_t, apply_j = _RECURRENT[kind]
    jcfg, cfg = _cfgs(arch, use_photonic_mac=photonic)
    r = _rng(21, len(kind), len(regime), int(photonic))
    pj, pt = _both(make_params(cfg, r))
    b, l = 2, (1 if regime == "decode" else 20)
    x = r.standard_normal((b, l, cfg.d_model)).astype(np.float32)
    cache = None
    if regime != "no_cache":
        cache = _recurrent_caches(cfg, kind, b, r)
        if regime == "prefill":
            cache = _zero_recurrent_cache(cache)
    ct = None if cache is None else {k: _t(v.copy()) for k, v in cache.items()}
    cj = None if cache is None else {k: jnp.asarray(v) for k, v in cache.items()}
    out_t, new_t = apply_t(cfg, pt, _t(x), cache=ct)
    out_j, new_j = apply_j(jcfg, pj, jnp.asarray(x), cache=cj)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL_BLOCK)
    if cache is None:
        assert new_j is None
        return
    assert new_t is ct                      # written into the views it was given
    assert set(ct) == set(new_j)
    for name in ct:
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(new_j[name]), **TOL_BLOCK)


# ---------------------------------------------------------------------------
# MoE (mixtral, grok-1)
# ---------------------------------------------------------------------------


def _moe_params(cfg, r, router_scale=1.0):
    m, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return _np_tree({
        "router": router_scale * r.standard_normal((m, e)) / np.sqrt(m),
        "wi": r.standard_normal((e, m, f)) / np.sqrt(m),
        "wg": r.standard_normal((e, m, f)) / np.sqrt(m),
        "wo": r.standard_normal((e, f, m)) / np.sqrt(f),
        "norm": 0.1 * r.standard_normal((m,))})


def _moe_pair(arch, r, x_shape, router_scale=1.0, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    pj, pt = _both(_moe_params(cfg, r, router_scale))
    x = r.standard_normal(x_shape).astype(np.float32)
    y_t, aux_t = L.apply_moe(cfg, pt, _t(x))
    y_j, aux_j = JL.apply_moe(jcfg, pj, jnp.asarray(x))
    return cfg, (y_t, aux_t), (y_j, aux_j)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "grok1_314b"])
@pytest.mark.parametrize("dispatch", ["einsum", "index"])
@pytest.mark.parametrize("photonic", [False, True])
def test_apply_moe_matches_reference(arch, dispatch, photonic):
    """Output (with residual) and the load-balance + z-loss aux, both
    dispatches, at the default capacity factor 1.25 (cap 15 slots for an
    expected load of 12)."""
    r = _rng(30, len(arch), len(dispatch), int(photonic))
    cfg, (y_t, aux_t), (y_j, aux_j) = _moe_pair(
        arch, r, (2, 24, 64), moe_dispatch=dispatch, use_photonic_mac=photonic)
    assert tuple(y_t.shape) == (2, 24, cfg.d_model) and y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL_BLOCK)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL_BLOCK)


@pytest.mark.parametrize("dispatch", ["einsum", "index"])
def test_apply_moe_forced_drops_match_reference(dispatch):
    """capacity_factor 0.5: 6 slots an expert for 12 expected choices, so
    many second (and some first) choices are dropped, in choices-major
    order.  The output differs from the no-drop one, so drops happened."""
    r = _rng(31, len(dispatch))
    _, (y_t, aux_t), (y_j, aux_j) = _moe_pair(
        "mixtral_8x7b", r, (2, 24, 64), moe_dispatch=dispatch, capacity_factor=0.5)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL_BLOCK)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL_BLOCK)
    _, (y_full, _), _ = _moe_pair("mixtral_8x7b", _rng(31, len(dispatch)), (2, 24, 64),
                                  moe_dispatch=dispatch, capacity_factor=8.0)
    assert not np.allclose(y_t.numpy(), y_full.numpy(), **TOL_BLOCK)


@pytest.mark.parametrize("dispatch", ["einsum", "index"])
def test_apply_moe_tied_router_picks_the_lowest_experts(dispatch):
    """Zero router weights: every probability ties, so every token's choices
    are experts 0 and 1 (as `jax.lax.top_k` orders ties), and expert 0's
    first choices overflow its 15 slots."""
    r = _rng(32, len(dispatch))
    _, (y_t, aux_t), (y_j, aux_j) = _moe_pair(
        "mixtral_8x7b", r, (2, 24, 64), router_scale=0.0, moe_dispatch=dispatch)
    _, idx = jax.lax.top_k(jnp.full((4,), 0.25), 2)
    assert np.asarray(idx).tolist() == [0, 1]
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL_BLOCK)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL_BLOCK)


@pytest.mark.parametrize("row", [[0.1, .3, .3, .3, 0.0, .3, .3, .3], [0.2] * 5 + [0.0] * 3,
                                 [0.5, 0.1, 0.5, 0.1, 0.5, 0.1, 0.5, 0.1]])
def test_top_k_orders_ties_as_jax(row):
    probs = np.asarray([row, row[::-1]], np.float32)
    v_t, i_t = L.top_k(_t(probs), 2)
    v_j, i_j = jax.lax.top_k(jnp.asarray(probs), 2)
    assert i_t.numpy().tolist() == np.asarray(i_j).tolist()
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("dispatch", ["einsum", "index"])
def test_moe_bf16_expert_storage_is_bit_identical_to_f32(dispatch):
    """The expert stacks stored in bf16 (as `init_moe` stores them for a
    bf16 model) give bit for bit the output of f32 masters that the block
    casts to bf16 on use."""
    _, cfg = _cfgs("mixtral_8x7b", dtype="bfloat16", moe_dispatch=dispatch)
    r = _rng(33, len(dispatch))
    p32 = {k: _t(v) for k, v in _moe_params(cfg, r).items()}
    p16 = {k: (v.to(torch.bfloat16) if k in ("wi", "wg", "wo") else v) for k, v in p32.items()}
    x = _t(r.standard_normal((2, 24, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    y32, aux32 = L.apply_moe(cfg, p32, x)
    y16, aux16 = L.apply_moe(cfg, p16, x)
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y32, y16) and torch.equal(aux32, aux16)


def test_init_moe_stores_the_experts_in_the_compute_dtype():
    m, f = 64, 128
    for dtype, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        _, cfg = _cfgs("mixtral_8x7b", dtype=dtype)
        gen = torch.Generator().manual_seed(0)
        p = L.init_moe(cfg, gen, device="cpu", layers=3)
        assert tuple(p["wi"].shape) == (3, 4, m, f) and tuple(p["wo"].shape) == (3, 4, f, m)
        assert p["wi"].dtype == p["wg"].dtype == p["wo"].dtype == want
        assert p["router"].dtype == p["norm"].dtype == torch.float32
        assert abs(float(p["wg"].float().std()) - m ** -0.5) < 0.01
        assert abs(float(p["wo"].float().std()) - f ** -0.5) < 0.01
        assert not torch.equal(p["wi"][0], p["wi"][1])   # layers drawn independently
