"""Parity of the whole ported path (`repro_torch.models.model`) with the JAX
package on the CPU, at a small size: the reference's random weights cross as
numpy through `params_from_reference`, and the same token ids go to both.

Tolerance: logits and caches agree to rtol/atol 1e-4 in f32.  Both sides do
the same f32 arithmetic; they differ in summation order and libm, and with
photonic numerics a product that falls within rounding of a quantization
boundary could flip a level, which has not occurred at these seeds.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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
from repro.models import model as JM  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

# a small config whose linears are all 128-aligned, so that with B*S = 128
# every layer takes the tiled photonic path (the reduced widths never do)
ALIGNED = dict(d_model=128, n_heads=4, n_kv_heads=1, head_dim=32, d_ff=256, vocab=512,
               use_photonic_mac=True)


def _pair(arch, seed=0, **kw):
    jcfg = dataclasses.replace(JC.get_reduced(arch), **kw)
    cfg = dataclasses.replace(C.get_reduced(arch), **kw)
    jparams, _ = JM.init(jcfg, jax.random.PRNGKey(seed))
    params = params_from_reference(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _assert_cache_close(cache_t, cache_j):
    """Every leaf of every block: K/V and the recurrent states alike."""
    assert len(cache_t) == len(cache_j)
    for st, sj in zip(cache_t, cache_j):
        assert set(st) == set(sj)
        for name in st:
            assert set(st[name]) == set(sj[name]), name
            for leaf in st[name]:
                np.testing.assert_allclose(st[name][leaf].numpy(),
                                           np.asarray(sj[name][leaf]), **TOL)


LOCAL_GLOBAL = dict(family="interleaved")

CASES = {
    "reduced": ("yi_6b", {}, 2, 24),
    "reduced_photonic": ("yi_6b", {"use_photonic_mac": True}, 2, 24),
    "reduced_photonic_4bit": ("yi_6b", {"use_photonic_mac": True, "photonic_bits": 4}, 2, 24),
    "yi_34b": ("yi_34b", {}, 2, 24),
    "deepseek_67b": ("deepseek_67b", {}, 2, 24),
    "deepseek_67b_photonic": ("deepseek_67b", {"use_photonic_mac": True}, 2, 24),
    # a GQA group of 7 (yi-34b's 56/8 heads is one), an odd group: JAX runs
    # its Pallas flash attention in interpret mode
    "yi_34b_gqa7_kernels": ("yi_34b", {"n_heads": 7, "n_kv_heads": 1, "use_kernels": True},
                            1, 128),
    # tiled path: JAX runs the Pallas kernels in interpret mode
    "aligned_tiled_kernels": ("yi_6b", {**ALIGNED, "use_kernels": True}, 1, 128),
    "aligned_tiled_plain": ("yi_6b", {**ALIGNED, "use_kernels": False}, 2, 64),
    # tied embeddings (gemma3's family is "dense", so its stages are plain `attn`)
    "gemma3": ("gemma3_27b", {}, 2, 24),
    # the local/global kinds with window 32: reachable only from a family
    # that `stages` does not catch first, in the reference and in the port
    "local_global": ("gemma3_27b", {**LOCAL_GLOBAL}, 2, 40),
    "local_global_photonic": ("gemma3_27b", {**LOCAL_GLOBAL, "use_photonic_mac": True}, 2, 40),
    "sliding": ("yi_6b", {"attn_pattern": "sliding", "window": 16}, 2, 24),
    # the recurrent families; zamba2's shared attention has window 32 here,
    # so S = 40 keeps the last 32 positions at prefill and rolls in decode
    "zamba2": ("zamba2_1p2b", {}, 2, 40),
    "zamba2_photonic": ("zamba2_1p2b", {"use_photonic_mac": True}, 2, 40),
    # S <= 128: JAX runs the Pallas scan and attention in interpret mode
    "zamba2_kernels": ("zamba2_1p2b", {"use_photonic_mac": True, "use_kernels": True}, 1, 40),
    "xlstm": ("xlstm_350m", {}, 2, 24),
    "xlstm_photonic": ("xlstm_350m", {"use_photonic_mac": True}, 2, 24),
    "xlstm_kernels": ("xlstm_350m", {"use_photonic_mac": True, "use_kernels": True}, 1, 24),
    # MoE: mixtral's window 32 here, so S = 40 keeps the last 32 positions
    # at prefill and rolls in decode; both dispatches; forced drops (cap 10
    # slots for 20 expected choices)
    "mixtral": ("mixtral_8x7b", {}, 2, 40),
    "mixtral_photonic": ("mixtral_8x7b", {"use_photonic_mac": True}, 2, 40),
    "mixtral_index": ("mixtral_8x7b", {"moe_dispatch": "index"}, 2, 40),
    "mixtral_drops": ("mixtral_8x7b", {"capacity_factor": 0.5}, 2, 40),
    # tiled attention linears and the windowed flash kernel at S = 128 > 32
    "mixtral_aligned_kernels": ("mixtral_8x7b", {**ALIGNED, "use_kernels": True}, 1, 128),
    "grok1": ("grok1_314b", {}, 2, 24),
    "grok1_index_photonic": ("grok1_314b", {"moe_dispatch": "index", "use_photonic_mac": True},
                             2, 24),
    # encoder-decoder: 2 encoder + 2 decoder layers against 6 frames (the
    # decoder's cross-attention at Sq != Sk)
    "seamless": ("seamless_m4t_medium", {}, 2, 24),
    "seamless_photonic": ("seamless_m4t_medium", {"use_photonic_mac": True}, 2, 24),
    # 128 tokens against 128 frames: the encoder's and the cross-attention
    # take the flash kernel (interpret mode in JAX), every linear tiles
    "seamless_aligned_kernels": ("seamless_m4t_medium", {**ALIGNED, "use_kernels": True},
                                 1, 128),
    # M-RoPE with distinct streams (a 4 x 4 patch grid, then text) and 16
    # pixel embeddings, which train_logits splices in and prefill ignores
    "qwen2_vl": ("qwen2_vl_72b", {}, 2, 24),
    "qwen2_vl_photonic": ("qwen2_vl_72b", {"use_photonic_mac": True}, 2, 24),
}
# encoder frames of the encoder-decoder cases
FRAMES = {"seamless": 6, "seamless_photonic": 6, "seamless_aligned_kernels": 128}


def mrope_positions(b, s, grid):
    """(3, B, S) M-RoPE streams of a `grid` x `grid` patch image followed by
    text: the patches at t = 0 and their row and column, then every stream
    at grid, grid + 1, ... (distinct streams, so a wrong section split
    shows)."""
    npix = grid * grid
    pos = np.empty((3, s), np.int32)
    pos[0, :npix] = 0
    pos[1, :npix] = np.arange(npix) // grid
    pos[2, :npix] = np.arange(npix) % grid
    pos[:, npix:] = grid + np.arange(s - npix)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, s)))


def _inputs(case, cfg, b, s, seed=0):
    """The case's batch as numpy arrays: token ids; for an encoder-decoder
    config its frames (B, Se, M); for a vision config distinct M-RoPE
    streams and 16 pixel embeddings."""
    batch = {"tokens": _tokens(cfg, b, s, seed)}
    r = np.random.default_rng([seed, 7])
    if cfg.encoder_layers:
        batch["enc_embeds"] = r.standard_normal(
            (b, FRAMES.get(case, 6), cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        batch["positions"] = mrope_positions(b, s, 4)
        batch["pixel_embeds"] = r.standard_normal((b, 16, cfg.d_model)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_train_logits_match_reference(case):
    arch, kw, b, s = CASES[case]
    jcfg, jparams, cfg, params = _pair(arch, **kw)
    batch = _inputs(case, cfg, b, s)
    out_t = M.train_logits(cfg, params, batch, device="cpu")
    out_j = JM.train_logits(jcfg, jparams, _jax(batch))
    assert tuple(out_t.shape) == (b, s, cfg.vocab) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_three_serve_steps_match_reference(case):
    arch, kw, b, s = CASES[case]
    jcfg, jparams, cfg, params = _pair(arch, seed=1, **kw)
    batch = _inputs(case, cfg, b, s + 3, seed=1)
    toks = batch["tokens"]
    prompt = {**batch, "tokens": toks[:, :s]}
    if "positions" in batch:
        prompt["positions"] = batch["positions"][:, :, :s]
    lg_t, cache_t = M.prefill(cfg, params, prompt, cache_len=s + 8, device="cpu")
    lg_j, cache_j = JM.prefill(jcfg, jparams, _jax(prompt), cache_len=s + 8)
    assert tuple(lg_t.shape) == (b, 1, cfg.vocab)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)
    _assert_cache_close(cache_t, cache_j)
    enc_t = enc_j = None
    if cfg.encoder_layers:      # the decode steps attend to the encoder's output
        enc_t = M.encode(cfg, params, batch["enc_embeds"], device="cpu")
        enc_j = JM.encode(jcfg, jparams, jnp.asarray(batch["enc_embeds"]))
    for i in range(3):
        tok = toks[:, s + i:s + i + 1]
        lg_t, cache_t = M.serve_step(cfg, params, cache_t, tok, s + i, enc_out=enc_t,
                                     device="cpu")
        lg_j, cache_j = JM.serve_step(jcfg, jparams, cache_j, jnp.asarray(tok),
                                      jnp.int32(s + i), enc_out=enc_j)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)
    _assert_cache_close(cache_t, cache_j)


@pytest.mark.parametrize("arch,kw", [("mixtral_8x7b", {}), ("grok1_314b", {}),
                                     ("mixtral_8x7b", {"moe_dispatch": "index",
                                                       "use_photonic_mac": True}),
                                     ("yi_6b", {})])
def test_forward_hidden_aux_matches_reference(arch, kw):
    """The auxiliary loss summed over the layers: each MoE block's
    load-balance loss plus 1e-3 of its router z-loss; zero without MoE."""
    jcfg, jparams, cfg, params = _pair(arch, seed=4, **kw)
    toks = _tokens(cfg, 2, 24, seed=4)
    h_t, aux_t = M.forward_hidden(cfg, params, {"tokens": toks}, device="cpu")
    h_j, aux_j = JM.forward_hidden(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)
    assert aux_t.shape == () and aux_t.dtype == torch.float32
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)
    assert (float(aux_t) > 0) == (cfg.family == "moe")


def test_moe_rolling_window_decode_matches_reference():
    """The reference's `test_sliding_window_cache_rolls` setting (mixtral,
    window 32, capacity factor 8, a 40-token prompt, 8 decode steps), step
    by step against the reference and against the port's full forward."""
    jcfg, jparams, cfg, params = _pair("mixtral_8x7b", seed=5, capacity_factor=8.0)
    s, extra = 40, 8
    toks = _tokens(cfg, 1, s + extra, seed=5)
    _, cache_t = M.prefill(cfg, params, {"tokens": toks[:, :s]}, cache_len=s + extra,
                           device="cpu")
    _, cache_j = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :s])},
                            cache_len=s + extra)
    assert cache_t[0]["moe_0"]["k"].shape[3] == 32
    for i in range(extra):
        tok = toks[:, s + i:s + i + 1]
        lg_t, cache_t = M.serve_step(cfg, params, cache_t, tok, s + i, device="cpu")
        lg_j, cache_j = JM.serve_step(jcfg, jparams, cache_j, jnp.asarray(tok),
                                      jnp.int32(s + i))
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)
    _assert_cache_close(cache_t, cache_j)
    full = M.train_logits(cfg, params, {"tokens": toks}, device="cpu")[:, -1]
    np.testing.assert_allclose(lg_t[:, 0].numpy(), full.numpy(), **TOL)


def test_rolling_window_decode_matches_reference():
    """Local blocks keep a 32-long cache: decode past it, so those caches roll."""
    jcfg, jparams, cfg, params = _pair("gemma3_27b", seed=2, **LOCAL_GLOBAL)
    assert M.stages(cfg) == [(1, ("local",) * 5 + ("global",))]
    s, extra = 28, 8
    toks = _tokens(cfg, 1, s + extra, seed=2)
    _, cache_t = M.prefill(cfg, params, {"tokens": toks[:, :s]}, cache_len=s + extra,
                           device="cpu")
    _, cache_j = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :s])},
                            cache_len=s + extra)
    assert cache_t[0]["local_0"]["k"].shape[3] == 32
    for i in range(extra):
        tok = toks[:, s + i:s + i + 1]
        lg_t, cache_t = M.serve_step(cfg, params, cache_t, tok, s + i, device="cpu")
        lg_j, cache_j = JM.serve_step(jcfg, jparams, cache_j, jnp.asarray(tok),
                                      jnp.int32(s + i))
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)
    _assert_cache_close(cache_t, cache_j)


@pytest.mark.parametrize("arch,kw", [("yi_6b", {}), ("gemma3_27b", {}),
                                     ("gemma3_27b", LOCAL_GLOBAL), ("zamba2_1p2b", {}),
                                     ("xlstm_350m", {}),
                                     ("mixtral_8x7b", {"capacity_factor": 8.0}),
                                     ("seamless_m4t_medium", {}), ("qwen2_vl_72b", {})])
def test_prefill_plus_decode_equals_full_forward(arch, kw):
    """Inside the port: the last position's logits from a full forward equal
    those of prefill(s-1) + one decode step (f32, no photonic numerics; MoE
    with a capacity that drops nothing, since drops legitimately depend on
    how many tokens route together; enc-dec against the same 6 frames,
    the decode step against their `encode`; M-RoPE with its default equal
    streams, which is what a decode step takes)."""
    cfg = dataclasses.replace(C.get_reduced(arch), **kw)
    params = M.init(cfg, seed=3, device="cpu")
    b, s = 2, 33
    batch = {k: v for k, v in _inputs(arch, cfg, b, s, seed=3).items()
             if k in ("tokens", "enc_embeds")}
    toks = batch["tokens"]
    full = M.train_logits(cfg, params, batch, device="cpu")[:, -1]
    _, cache = M.prefill(cfg, params, {**batch, "tokens": toks[:, :s - 1]}, cache_len=s,
                         device="cpu")
    enc_out = (M.encode(cfg, params, batch["enc_embeds"], device="cpu")
               if cfg.encoder_layers else None)
    lg, _ = M.serve_step(cfg, params, cache, toks[:, s - 1:s], s - 1, enc_out=enc_out,
                         device="cpu")
    np.testing.assert_allclose(lg[:, 0].numpy(), full.numpy(), rtol=1e-4, atol=1e-4)


def test_init_shapes_and_statistics():
    cfg = C.get_reduced("yi_6b")
    p = M.init(cfg, seed=0, device="cpu")
    jp, _ = JM.init(JC.get_reduced("yi_6b"), jax.random.PRNGKey(0))
    shapes_t = jax.tree.map(lambda t: tuple(t.shape), p)
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert shapes_t == shapes_j
    wq = p["stages"][0]["attn_0"]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.01
    assert not torch.equal(wq[0], wq[1])              # layers drawn independently
    again = M.init(cfg, seed=0, device="cpu")
    assert torch.equal(again["embed"], p["embed"])     # seeded


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_350m"])
def test_recurrent_init_and_cache_trees_match_reference(arch):
    """The port's parameter and cache trees have the reference's leaves,
    shapes and dtypes, and the initial values the reference gives
    (slstm 'm' at -10, mamba decay and skip parameters)."""
    cfg, jcfg = C.get_reduced(arch), JC.get_reduced(arch)
    p = M.init(cfg, seed=0, device="cpu")
    jp, _ = JM.init(jcfg, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: tuple(t.shape), p) == jax.tree.map(lambda a: tuple(a.shape), jp)
    for leaf in ("A_log", "D", "dt_bias"):
        for sp, jsp in zip(p["stages"], jp["stages"]):
            for name in (n for n in sp if n.startswith("mamba")):
                np.testing.assert_array_equal(sp[name]["mamba"][leaf].numpy(),
                                              np.asarray(jsp[name]["mamba"][leaf]))
    cache = M.init_cache(cfg, 3, 16, device="cpu")
    jcache, _ = JM.init_cache(jcfg, 3, 16)
    dt = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    assert (jax.tree.map(lambda t: (tuple(t.shape), dt[t.dtype]), cache)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jcache))
    _assert_cache_close(cache, jcache)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "grok1_314b"])
def test_moe_init_and_cache_trees_match_reference(arch):
    """MoE blocks hold attention and experts and no MLP, with the
    reference's leaves, shapes and dtypes (f32 at the reduced size), and
    keep a K/V cache of at most the window (mixtral 32, grok-1 unwindowed)."""
    cfg, jcfg = C.get_reduced(arch), JC.get_reduced(arch)
    p = M.init(cfg, seed=0, device="cpu")
    jp, _ = JM.init(jcfg, jax.random.PRNGKey(0))
    dt = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    assert (jax.tree.map(lambda t: (tuple(t.shape), dt[t.dtype]), p)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp))
    assert set(p["stages"][0]["moe_0"]) == {"attn", "moe"}
    cache = M.init_cache(cfg, 3, 48, device="cpu")
    jcache, _ = JM.init_cache(jcfg, 3, 48)
    assert (jax.tree.map(lambda t: (tuple(t.shape), dt[t.dtype]), cache)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jcache))
    assert cache[0]["moe_0"]["k"].shape[3] == (cfg.window or 48)


@pytest.mark.parametrize("photonic", [False, True])
def test_encode_matches_reference(photonic):
    """The encoder alone: positions 0 .. Se-1, non-causal attention and the
    MLP in each block, then the encoder's norm; enc_out in the compute
    dtype."""
    jcfg, jparams, cfg, params = _pair("seamless_m4t_medium", seed=6,
                                       use_photonic_mac=photonic)
    enc = np.random.default_rng(6).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    out_t = M.encode(cfg, params, enc, device="cpu")
    out_j = JM.encode(jcfg, jparams, jnp.asarray(enc))
    assert tuple(out_t.shape) == (2, 9, cfg.d_model) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_encdec_init_and_cache_trees_match_reference():
    """seamless holds decoder blocks (attention, cross-attention, MLP) and
    an encoder tree {'blocks': {attn, mlp}, 'norm'} with no `enc_0` level,
    with the reference's leaves, shapes and dtypes; its decoder keeps a
    full-length K/V cache and the cross-attention none."""
    cfg, jcfg = C.get_reduced("seamless_m4t_medium"), JC.get_reduced("seamless_m4t_medium")
    p = M.init(cfg, seed=0, device="cpu")
    jp, _ = JM.init(jcfg, jax.random.PRNGKey(0))
    dt = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    assert (jax.tree.map(lambda t: (tuple(t.shape), dt[t.dtype]), p)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp))
    assert set(p["stages"][0]["dec_0"]) == {"attn", "cross", "mlp"}
    assert set(p["encoder"]["blocks"]) == {"attn", "mlp"}
    assert p["encoder"]["blocks"]["attn"]["wq"].shape[0] == cfg.encoder_layers
    cache = M.init_cache(cfg, 3, 40, device="cpu")
    jcache, _ = JM.init_cache(jcfg, 3, 40)
    assert (jax.tree.map(lambda t: (tuple(t.shape), dt[t.dtype]), cache)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jcache))
    assert set(cache[0]["dec_0"]) == {"k", "v"} and cache[0]["dec_0"]["k"].shape[3] == 40


def test_encoder_decoder_entry_points_need_the_encoder_input():
    """Without frames a prefill, and without `enc_out` a decode step, raise
    `ValueError` naming what is missing (the reference fails with a
    KeyError or a TypeError deep inside)."""
    cfg = C.get_reduced("seamless_m4t_medium")
    params = M.init(cfg, seed=0, device="cpu")
    toks = _tokens(cfg, 1, 8)
    with pytest.raises(ValueError, match="enc_embeds"):
        M.prefill(cfg, params, {"tokens": toks}, device="cpu")
    with pytest.raises(ValueError, match="enc_embeds"):
        M.train_logits(cfg, params, {"tokens": toks}, device="cpu")
    cache = M.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="enc_out"):
        M.serve_step(cfg, params, cache, toks[:, :1], 0, device="cpu")


def test_encoder_depth_is_checked():
    """Weights whose encoder is deeper than the config's raise `ValueError`,
    in the conversion and at every entry point that runs the layers."""
    cfg = C.get_reduced("seamless_m4t_medium")
    deep = dataclasses.replace(cfg, encoder_layers=3)
    jparams, _ = JM.init(dataclasses.replace(JC.get_reduced("seamless_m4t_medium"),
                                             encoder_layers=3), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="encoder.blocks.attn.wq has 3 layers, expected 2"):
        params_from_reference(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    params = M.init(deep, seed=0, device="cpu")
    enc = np.zeros((1, 4, cfg.d_model), np.float32)
    with pytest.raises(ValueError, match="2 encoder layers, the parameters 3"):
        M.encode(cfg, params, enc, device="cpu")
    with pytest.raises(ValueError, match="2 encoder layers, the parameters 3"):
        M.prefill(cfg, params, {"tokens": _tokens(cfg, 1, 4), "enc_embeds": enc},
                  device="cpu")


def test_pixel_embeds_reach_forward_hidden_and_not_prefill():
    """In both packages: `forward_hidden` splices the pixel embeddings over
    the first npix positions (the hidden states move, and agree with the
    reference's), and `prefill` ignores them (bit-identical logits with and
    without)."""
    jcfg, jparams, cfg, params = _pair("qwen2_vl_72b", seed=8)
    batch = _inputs("qwen2_vl", cfg, 2, 24, seed=8)
    text = {k: v for k, v in batch.items() if k != "pixel_embeds"}
    h_t, _ = M.forward_hidden(cfg, params, batch, device="cpu")
    h_j, _ = JM.forward_hidden(jcfg, jparams, _jax(batch))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)
    h_text, _ = M.forward_hidden(cfg, params, text, device="cpu")
    assert float((h_t - h_text).abs().max()) > 1e-2
    lg_t, _ = M.prefill(cfg, params, batch, device="cpu")
    assert torch.equal(lg_t, M.prefill(cfg, params, text, device="cpu")[0])
    lg_j, _ = JM.prefill(jcfg, jparams, _jax(batch))
    np.testing.assert_array_equal(np.asarray(lg_j), np.asarray(JM.prefill(jcfg, jparams,
                                                                           _jax(text))[0]))


@pytest.mark.parametrize("offset", [0, np.array([3, 9])])
def test_mrope_default_positions_are_the_index_on_every_stream(offset):
    """Text and decode positions: (3, B, S), the token index (plus a scalar
    or per-slot offset) on all three streams, as the reference gives them."""
    cfg, jcfg = C.get_reduced("qwen2_vl_72b"), JC.get_reduced("qwen2_vl_72b")
    pos = M.default_positions(cfg, 2, 5, offset=torch.as_tensor(offset), device="cpu")
    assert tuple(pos.shape) == (3, 2, 5)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(JM.default_positions(
        jcfg, 2, 5, offset=jnp.asarray(offset))))


def test_default_device_is_cuda_and_raises_without_a_card():
    """No silent CPU fallback: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")
    cfg = C.get_reduced("yi_6b")
    with pytest.raises(RuntimeError, match="cuda"):
        M.init(cfg)
    params = M.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        M.prefill(cfg, params, {"tokens": _tokens(cfg, 1, 4)})
    with pytest.raises(RuntimeError, match="cuda"):
        M.init_cache(cfg, 1, 8)


def test_stage_layout_matches_reference():
    for arch in C.ARCH_IDS:
        assert M.stages(C.get(arch)) == JM.stages(JC.get(arch))


def test_port_imports_without_jax_or_the_reference_package():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.env, repro_torch.configs\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "import repro_torch.kernels.ssm_scan\n"
        "import repro_torch.models.model, repro_torch.models.convert\n"
        "import repro_torch.serve.engine, repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": src})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
