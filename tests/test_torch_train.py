"""Parity of the port's training path with the JAX package on the CPU, at a
small size: `loss_fn` and its gradients, the kernels' backwards, AdamW, the
train step and the trainer.  The reference's random weights and training
state cross as numpy (`params_from_reference`, `state_from_reference`), and
the same numpy batches go to both.

Tolerances: losses and their ce/aux at rtol 1e-5 (both sides do the same
f32 arithmetic, in another order); every gradient leaf at rtol 1e-4 and an
atol of 1e-4 of the leaf's largest entry; AdamW fed the same gradients at
rtol 1e-6 and an atol of 1e-6 of the leaf's largest entry (an update's last
bit is that of its largest term, lr * update, which a master near zero
keeps; a bf16 moment may land one bf16 step away where its f32 value lies
within rounding of a bf16 boundary, so bf16 leaves are held to one bf16
step, 2^-8); the ops' backwards at rtol 1e-5 (f32) and 2e-2
(bf16 inputs) of each gradient's largest entry; three trainer steps' losses
at rtol 1e-4.
"""

import dataclasses
import functools
import os

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
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.runtime import trainer as JT  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_reference, state_from_reference  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import trainer as TR  # noqa: E402

# a small config whose linears are all 128-aligned: at B = 2, S = 128 and
# loss_chunk 64 every product, the head's included, takes the tiled
# photonic path (JAX runs the Pallas kernels in interpret mode)
ALIGNED = dict(d_model=128, n_heads=4, n_kv_heads=1, head_dim=32, d_ff=256, vocab=512,
               use_photonic_mac=True)

# (arch, config changes, batch, seq): one per family, and the aligned
# photonic config with the kernels
CASES = {
    "dense": ("yi_6b", {}, 2, 64),
    "hybrid": ("zamba2_1p2b", {}, 2, 64),
    "ssm": ("xlstm_350m", {}, 2, 64),
    "moe": ("mixtral_8x7b", {}, 2, 64),
    "moe_index": ("mixtral_8x7b", {"moe_dispatch": "index"}, 2, 64),
    "vlm": ("qwen2_vl_72b", {"rope_theta": 100.0}, 2, 64),
    "encdec": ("seamless_m4t_medium", {}, 2, 64),
    "aligned_photonic_kernels": ("yi_6b", {**ALIGNED, "use_kernels": True}, 2, 128),
}
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _low_cpu_priority():
    """This module compiles and runs both packages for minutes of CPU time;
    it runs at a lower scheduling priority so that timing-gated tests that
    share the machine (the benchmark smoke tests' ratio bars) keep theirs.
    The priority is restored where the process may raise it again."""
    os.nice(10)
    yield
    try:
        os.nice(-10)
    except PermissionError:
        pass


@functools.lru_cache(maxsize=None)
def _ref_init(arch, kw):
    jcfg = dataclasses.replace(JC.get_reduced(arch), **dict(kw))
    return jcfg, jax.jit(lambda key: JM.init(jcfg, key)[0])(jax.random.PRNGKey(0))


def _pair(arch, **kw):
    """The reference's reduced config and weights (seed 0; built once per
    config in this module: tests only read them), and the port's."""
    jcfg, jparams = _ref_init(arch, tuple(sorted(kw.items())))
    cfg = dataclasses.replace(C.get_reduced(arch), **kw)
    params = params_from_reference(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, b, s, step=0):
    """The reference's `SyntheticLM` batch; a vision config's keeps 16 of its
    pixel embeddings and takes distinct M-RoPE streams (a 4 x 4 patch grid
    at t = 0, then text), so that tokens and every stream matter."""
    batch = JSyntheticLM(cfg, JDataConfig(global_batch=b, seq_len=s)).batch_at(step)
    if cfg.mrope:
        grid, npix = 4, 16
        pos = np.empty((3, s), np.int32)
        pos[0, :npix], pos[1, :npix], pos[2, :npix] = 0, np.arange(npix) // grid, np.arange(npix) % grid
        pos[:, npix:] = grid + np.arange(s - npix)
        batch["positions"] = np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, s)))
        batch["pixel_embeds"] = batch["pixel_embeds"][:, :npix]
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _requires_grad(params):
    return T.map_structure(lambda p: p.detach().requires_grad_(True), params)


def _port_grads(cfg, params, batch):
    params = _requires_grad(params)
    loss, mets = M.loss_fn(cfg, params, batch, device="cpu")
    names = [n for n, _ in T.leaves_with_path(params)]
    grads = torch.autograd.grad(loss, T.leaves(params), allow_unused=True, materialize_grads=True)
    return loss, mets, dict(zip(names, grads))


def _ref_grads(jcfg, jparams, batch):
    (loss, mets), g = jax.jit(jax.value_and_grad(lambda p, bt: JM.loss_fn(jcfg, p, bt),
                                                 has_aux=True))(jparams, _jax(batch))
    named = {jax.tree_util.keystr(kp): np.asarray(v)
             for kp, v in jax.tree_util.tree_leaves_with_path(g)}
    return loss, mets, named


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_reference(case):
    arch, kw, b, s = CASES[case]
    jcfg, jparams, cfg, params = _pair(arch, **kw)
    batch = _batch(cfg, b, s)
    loss_t, mets_t, g_t = _port_grads(cfg, params, batch)
    loss_j, mets_j, g_j = _ref_grads(jcfg, jparams, batch)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(mets_t[k]), float(mets_j[k]), rtol=LOSS_RTOL,
                                   atol=1e-7 if k == "aux" else 0)
    assert set(g_t) == set(g_j)
    for name, gj in g_j.items():
        gt = g_t[name].numpy()
        assert gt.shape == gj.shape and gt.dtype == gj.dtype, name
        np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-4 * float(np.abs(gj).max()),
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "seamless_m4t_medium", "mixtral_8x7b"])
def test_remat_changes_no_number(arch):
    """Recomputation under `torch.utils.checkpoint` (per stage repeat, per
    encoder layer, per CE chunk) gives the loss and gradients of saving
    everything, bit for bit on the CPU."""
    _, _, cfg, params = _pair(arch)
    batch = _batch(cfg, 2, 128)
    out = {}
    for remat in ("none", "full"):
        out[remat] = _port_grads(dataclasses.replace(cfg, remat=remat), params, batch)
    assert torch.equal(out["none"][0], out["full"][0])
    for name, g in out["none"][2].items():
        assert torch.equal(g, out["full"][2][name]), name


def test_loss_chunk_must_divide_the_sequence():
    _, _, cfg, params = _pair("yi_6b")
    with pytest.raises(ValueError, match="loss_chunk"):
        M.loss_fn(cfg, params, _batch(cfg, 1, 96), device="cpu")


# ---------------------------------------------------------------------------
# the ops' backwards against the reference's custom_vjps
# ---------------------------------------------------------------------------


def _cotangent(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _vjp_pair(fn_t, fn_j, arrays, dtypes, out_shape, arrays_j=None):
    """Gradients of <fn(*arrays), g> by torch autograd and by `jax.vjp`, each
    input cast to its dtype first (numpy f32 arrays in; the reference takes
    `arrays_j` where its inputs differ in layout)."""
    g = _cotangent(out_shape)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    ts = [torch.from_numpy(a).to(tdt[d]).requires_grad_(True) for a, d in zip(arrays, dtypes)]
    out_t = fn_t(*ts)
    gt = torch.autograd.grad(out_t, ts, torch.from_numpy(g))
    js = [jnp.asarray(a).astype(jdt[d]) for a, d in zip(arrays_j or arrays, dtypes)]
    out_j, vjp = jax.vjp(fn_j, *js)
    gj = vjp(jnp.asarray(g))
    return out_t, out_j, gt, gj


def _close(gt, gj, rtol, what):
    gj = np.asarray(gj.astype(jnp.float32))
    assert tuple(gt.shape) == gj.shape, what
    np.testing.assert_allclose(gt.float().numpy(), gj, rtol=rtol,
                               atol=rtol * float(np.abs(gj).max()), err_msg=what)


RTOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (24, 64, 40)])  # tiled; per-column
def test_photonic_matmul_backward_matches_reference(xdt, m, k, n):
    """Straight-through: dx = g w^T cast to x's dtype, dw = x^T g cast to
    w's dtype, on the tiled and the per-column paths alike."""
    r = np.random.default_rng(0)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = (r.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    assert ops.uses_tiled_path(m, k, n) == (m == 128)
    out_t, out_j, (dx_t, dw_t), (dx_j, dw_j) = _vjp_pair(
        lambda x_, w_: ops.photonic_matmul(x_, w_, 8, False),
        lambda x_, w_: JO.photonic_matmul(x_, w_, 8, False), [x, w], [xdt, "f32"], (m, n))
    assert dx_t.dtype == (torch.bfloat16 if xdt == "bf16" else torch.float32)
    assert dx_j.dtype == (jnp.bfloat16 if xdt == "bf16" else jnp.float32)
    assert dw_t.dtype == torch.float32 and dw_j.dtype == jnp.float32
    _close(dx_t, dx_j, RTOL[xdt], "dx")
    _close(dw_t, dw_j, RTOL[xdt], "dw")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hq,hk,window", [(4, 2, 0), (4, 2, 16), (4, 4, 16)])
def test_attention_backward_matches_reference(dt, hq, hk, window):
    """GQA (two query heads a KV head: dk and dv sum over the group) and a
    sliding window; the gradients come back in the inputs' dtype."""
    r = np.random.default_rng(1)
    b, s, d = 2, 64, 16
    q = r.standard_normal((b, hq, s, d)).astype(np.float32)
    k = r.standard_normal((b, hk, s, d)).astype(np.float32)
    v = r.standard_normal((b, hk, s, d)).astype(np.float32)
    _, _, gt, gj = _vjp_pair(
        lambda q_, k_, v_: ops.attention(q_, k_, v_, True, window, None, 0, False),
        lambda q_, k_, v_: JO.attention(q_, k_, v_, True, window, None, 0, False),
        [q, k, v], [dt] * 3, (b, hq, s, d))
    for name, a, bj in zip("qkv", gt, gj):
        assert a.dtype == (torch.bfloat16 if dt == "bf16" else torch.float32)
        _close(a, bj, RTOL[dt], "d" + name)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssm_backward_matches_reference(dt):
    """Grouped b/c (G = 2 groups of 3 heads): the port takes b and c per
    group, the reference per head, so the reference's db and dc are summed
    over each group's heads."""
    r = np.random.default_rng(2)
    g_, h, l, p, n = 2, 3, 64, 8, 4
    bh = g_ * h
    x = (r.standard_normal((bh, l, p)) * 0.5).astype(np.float32)
    a = (0.68 + 0.3 / (1 + np.exp(-r.standard_normal((bh, l))))).astype(np.float32)
    bg = (r.standard_normal((g_, l, n)) * 0.3).astype(np.float32)
    cg = (r.standard_normal((g_, l, n)) * 0.3).astype(np.float32)
    per_head = lambda t: np.repeat(t, h, axis=0)  # noqa: E731
    _, _, gt, gj = _vjp_pair(
        lambda x_, a_, b_, c_: ops.ssm(x_, a_, b_, c_, False),
        lambda x_, a_, b_, c_: JO.ssm(x_, a_, b_, c_, False),
        [x, a, bg, cg], [dt, "f32", dt, dt], (bh, l, p),
        arrays_j=[x, a, per_head(bg), per_head(cg)])
    for name, a_t, a_j in zip(("x", "a"), gt[:2], gj[:2]):
        _close(a_t, a_j, RTOL[dt], "d" + name)
    for name, a_t, a_j in zip(("b", "c"), gt[2:], gj[2:]):
        summed = np.asarray(a_j.astype(jnp.float32)).reshape(g_, h, l, n).sum(1)
        _close(a_t, jnp.asarray(summed), RTOL[dt], "d" + name)
        assert a_t.dtype == (torch.bfloat16 if dt == "bf16" else torch.float32)


# ---------------------------------------------------------------------------
# AdamW, the train step, the trainer
# ---------------------------------------------------------------------------


OPT = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=16)
JOPT = JA.OptConfig(lr=1e-3, warmup_steps=2, total_steps=16)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(state_dtype):
    """Three updates (through warmup, one past the clip norm, the bias
    corrections of steps 1-3), each fed the same state and the same
    gradients, so that a bf16 moment one step away does not carry into the
    next update."""
    jcfg, jparams, cfg, _ = _pair("zamba2_1p2b")
    jopt = dataclasses.replace(JOPT, state_dtype=state_dtype)
    opt = dataclasses.replace(OPT, state_dtype=state_dtype)
    jstate = JA.init_state(jopt, jparams)
    r = np.random.default_rng(5)
    for i in range(3):
        scale = 0.01 if i else 10.0           # step 1 clips, the others do not
        np_grads = jax.tree.map(lambda p: (r.standard_normal(p.shape) * scale)
                                .astype(np.float32), jparams)
        state = state_from_reference(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
        jstate = jax.jit(JA.apply_updates, static_argnums=0)(jopt, jstate, np_grads)
        state = adamw.apply_updates(opt, state, params_from_reference(cfg, np_grads, "cpu"))
        got = dict(T.leaves_with_path(state))
        assert int(got[".step"]) == i + 1
        for kp, want in jax.tree_util.tree_leaves_with_path(jstate):
            name = jax.tree_util.keystr(kp)
            t = got[name]
            want = np.asarray(want.astype(jnp.float32))
            rtol = 2 ** -8 if t.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(t.float().numpy(), want, rtol=rtol,
                                       atol=rtol * float(np.abs(want).max()), err_msg=name)
    np.testing.assert_allclose(float(adamw.schedule(opt, torch.tensor(3, dtype=torch.int32))),
                               float(JA.schedule(jopt, jnp.int32(3))), rtol=1e-7)


def test_grad_accumulation_matches_full_batch():
    """accum_steps=2 over half-microbatches == one full-batch step (the CE is
    a per-token mean and the microbatches are equal-sized), with the
    reference test's tolerances."""
    cfg = C.get_reduced("yi_6b")
    params = M.init(cfg, device="cpu")
    batch = TR._to_device(JSyntheticLM(cfg, JDataConfig(global_batch=4, seq_len=64)).batch_at(0),
                          torch.device("cpu"))
    s1, m1 = TR.make_train_step(cfg, OPT, device="cpu")(adamw.init_state(OPT, params), batch)
    s2, m2 = TR.make_train_step(cfg, OPT, accum_steps=2, device="cpu")(
        adamw.init_state(OPT, params), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for a, b in zip(T.leaves(s1.params), T.leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


def test_split_microbatches_splits_mrope_positions_on_the_batch_axis():
    batch = {"tokens": torch.arange(4 * 6).reshape(4, 6),
             "positions": torch.arange(3 * 4 * 6).reshape(3, 4, 6)}
    mbs = TR._split_microbatches(batch, 2)
    assert tuple(mbs["tokens"].shape) == (2, 2, 6)
    assert tuple(mbs["positions"].shape) == (2, 3, 2, 6)
    assert torch.equal(mbs["positions"][1], batch["positions"][:, 2:])
    assert torch.equal(mbs["tokens"][1], batch["tokens"][2:])
    jmbs = JT._split_microbatches({k: jnp.asarray(v.numpy()) for k, v in batch.items()}, 2)
    for k in batch:
        np.testing.assert_array_equal(mbs[k].numpy(), np.asarray(jmbs[k]))


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "mixtral_8x7b"])
def test_three_trainer_steps_match_reference(tmp_path, arch):
    """Both trainers from one state (`state_from_reference`), on the same
    `SyntheticLM` batches: the losses of three steps."""
    jcfg, cfg = JC.get_reduced(arch), C.get_reduced(arch)
    data = (JDataConfig(global_batch=2, seq_len=64), DataConfig(global_batch=2, seq_len=64))
    jt = JT.Trainer(jcfg, JOPT, data[0], JT.TrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                                          ckpt_every=100, log_every=1000),
                    resume=False)
    state = state_from_reference(cfg, jax.tree.map(np.asarray, jt.state), device="cpu")
    pt = TR.Trainer(cfg, OPT, data[1], TR.TrainerConfig(ckpt_dir=str(tmp_path / "t"),
                                                        ckpt_every=100, log_every=1000),
                    resume=False, device="cpu", state=state)
    jt.run(3, quiet=True)
    pt.run(3, quiet=True)
    lj = [h["loss"] for h in jt.history]
    lt = [h["loss"] for h in pt.history]
    assert len(lt) == 3
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    np.testing.assert_allclose([h["grad_norm"] for h in pt.history],
                               [h["grad_norm"] for h in jt.history], rtol=1e-3)
