"""Parity of the port's parameter wire (`repro_torch.parallel.wire`) and of
its train step under the wire with the JAX package on the CPU, and the
counterparts of the reference's own wire tests (`tests/test_kernels.py`'s
`test_wire_quant_leaf_numerics_and_ste` and
`test_wire_grads_close_to_master`, `tests/test_runtime.py`'s
`test_wire_format_training_converges`), run on the port.

The reference's `ParamWire` constrains its tensors to a mesh's shardings.
On this jax a mesh built by `jax.make_mesh((1, 1), ...)` has Explicit axes,
under which `with_sharding_constraint` raises; a (1, 1) mesh with Auto axes
(`_ref_mesh`) runs it, so the whole wire path has an oracle here.

Tolerances: int8 levels and scales, and every transformed leaf of the
wire's tree (pairs, `_quant_leaf`'s per-tensor treatment of stacked 2-D
leaves, the bf16 casts), exactly: both sides do the same f32 and bf16
arithmetic.  The photonic product of bf16 weights at 1e-6 of its largest
output (the reference op by op; compiled, it keeps the bf16 scales
unrounded, 1.5e-3 away), its bf16 dw at one bf16 step.  Losses at rtol
1e-5.  Master gradients per leaf within one
bf16 step (2^-8) of the leaf's norm: under the wire a weight reaches the
model in bf16, so its gradient is rounded to bf16 where the model casts
it, and two summation orders may land one bf16 step apart; the worst seen
is 7.7e-4 (zamba2, 8 bits).

The reference's train step runs op by op (`jax.disable_jit()`).  Compiled,
XLA keeps a bf16 product in f32 where a cast to f32 consumes it (excess
precision): `_quant_leaf`'s bf16 weights then reach an f32 model unrounded,
and on reduced zamba2 under the 8-bit wire the jitted step's loss (and
its `accum_steps=2` scan, compiled even without `jit`) moves by 2.4e-4
from the mean of its own microbatches' losses.  Op by op, every product
rounds as written, as the port's do.
"""

import dataclasses
import functools
import os

import jax
import jax.experimental
import numpy as np
import pytest
import torch

# `repro.models` pulls in `repro.core`, whose power model imports
# `jax.experimental.enable_x64`; newer jax only has `jax.enable_x64`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro.parallel import wire as JW  # noqa: E402
from repro.runtime import trainer as JT  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_reference, state_from_reference  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import wire as W  # noqa: E402
from repro_torch.runtime import trainer as TR  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 2 ** -8
# the reference test's settings (tests/test_runtime.py)
OPT = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=16)
JOPT = JA.OptConfig(lr=1e-3, warmup_steps=2, total_steps=16)
DATA = DataConfig(global_batch=2, seq_len=64)


@pytest.fixture(scope="module", autouse=True)
def _low_cpu_priority():
    """This module runs both packages for minutes of CPU time; it runs at a
    lower scheduling priority so that timing-gated tests that share the
    machine keep theirs (as `tests/test_torch_train.py` does)."""
    os.nice(10)
    yield
    try:
        os.nice(-10)
    except PermissionError:
        pass


def _ref_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))


@functools.lru_cache(maxsize=None)
def _ref_init(arch):
    jcfg = JC.get_reduced(arch)
    jparams, specs = JM.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, specs


def _pair(arch):
    """The reference's reduced config, weights (seed 0) and specs, and the
    port's config and weights (the same numbers)."""
    jcfg, jparams, specs = _ref_init(arch)
    cfg = C.get_reduced(arch)
    params = params_from_reference(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, specs, cfg, params


def _ref_wire(jcfg, specs, bits):
    mesh = _ref_mesh()
    return JW.make_param_wire(dataclasses.replace(jcfg, wire_bits=bits), mesh,
                              JS.rules_for(jcfg, mesh), specs)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jnp_np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _named(jtree) -> dict:
    return {jax.tree_util.keystr(kp): v for kp, v in jax.tree_util.tree_leaves_with_path(jtree)}


def _requires_grad(tree):
    return T.map_structure(lambda p: p.detach().requires_grad_(True), tree)


def _assert_grads_close(got: dict, want: dict, what):
    assert set(got) == set(want), what
    for name, g in got.items():
        a = np.asarray(want[name], np.float32)
        nd = float(np.linalg.norm(_np(g) - a))
        assert nd <= GRAD_NORM_RTOL * float(np.linalg.norm(a)) + 1e-12, (what, name, nd)


# ---------------------------------------------------------------------------
# leaf numerics
# ---------------------------------------------------------------------------


def _weights(shape, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if len(shape) >= 3:           # layers of very different ranges
        w *= (10.0 ** np.arange(shape[0], dtype=np.float32)).reshape((-1,) + (1,) * (len(shape) - 1))
    return w


SHAPES = [(64, 32), (3, 64, 32), (2, 4, 16, 8)]


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_array_matches_reference(shape, bits):
    """Levels and scales exactly: one scale per leading index for ndim >= 3,
    one per tensor for 2-D; at 16 bits the levels saturate in int8 on both
    sides, as XLA's conversion does."""
    w = _weights(shape)
    jq, js = JW._quantize_array(jnp.asarray(w), bits)
    q, s = W._quantize_array(torch.from_numpy(w), bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == js.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("shape", SHAPES)
def test_quant_leaf_value_and_straight_through_match_reference(shape, bits, cdt):
    """`_quant_leaf`'s value in the compute dtype equals the reference's
    exactly; its gradient is straight through, f32, and equals the
    reference's for the same cotangent."""
    w = _weights(shape)
    tdt, jdt = getattr(torch, cdt), getattr(jnp, cdt)
    want = JW._quant_leaf(jnp.asarray(w), bits, None, jdt)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = W._quant_leaf(wt, bits, tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), _jnp_np(want))
    jg = jax.grad(lambda x: jnp.sum(JW._quant_leaf(x, bits, None, jdt).astype(jnp.float32) ** 2))(
        jnp.asarray(w))
    (g,) = torch.autograd.grad(torch.sum(got.float() ** 2), wt)
    assert g.dtype == torch.float32
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_quant_leaf_numerics_and_ste_on_the_port():
    """The reference test's bars (`test_wire_quant_leaf_numerics_and_ste`)
    on the port: within half a quantization step of the master, the
    gradient of sum(wd^2) is 2 wd, and a stacked leaf scales per layer."""
    w = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64, 32),
                                                      jnp.float32)))
    wd = W._quant_leaf(w, 8, torch.float32)
    step = torch.max(torch.abs(w)) / 127.0
    assert float(torch.max(torch.abs(wd - w))) <= float(step) / 2 + 1e-6
    wr = w.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(W._quant_leaf(wr, 8, torch.float32) ** 2), wr)
    np.testing.assert_allclose(g.numpy(), (2 * wd).numpy(), rtol=1e-5)
    wds = W._quant_leaf(torch.stack([w, 100.0 * w]), 8, torch.float32)
    np.testing.assert_allclose((wds[1] / 100.0).numpy(), wds[0].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_delta", [False, True])
def test_dequant_subtree_matches_reference(with_delta, cdt):
    """Pairs (with and without `~d`) dequantize to the reference's values,
    the scale rounded to the compute dtype first; other leaves pass."""
    tdt, jdt = getattr(torch, cdt), getattr(jnp, cdt)
    w = _weights((3, 64, 32))
    jq, js = JW._quantize_array(jnp.asarray(w), 8)
    d = (np.random.default_rng(1).standard_normal(w.shape) * 1e-3).astype(np.float32)
    norm = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)
    jtree = {"w": {"~q": jq, "~s": js}, "norm": jnp.asarray(norm)}
    tree = {"w": {"~q": torch.from_numpy(np.asarray(jq)), "~s": torch.from_numpy(np.asarray(js))},
            "norm": torch.from_numpy(norm)}
    if with_delta:
        jtree["w"]["~d"] = jnp.asarray(d)
        tree["w"]["~d"] = torch.from_numpy(d)
    want = JW.dequant_subtree(jtree, jdt)
    got = W.dequant_subtree(tree, tdt)
    assert got["w"].dtype == tdt
    np.testing.assert_array_equal(_np(got["w"]), _jnp_np(want["w"]))
    assert got["norm"] is tree["norm"]


def test_dequant_subtree_without_pairs_returns_the_same_tensors():
    """No pair: the very tree given, every tensor the same object (no
    copy), so the paths without a wire keep their numbers and launches."""
    cfg = C.get_reduced("zamba2_1p2b")
    params = M.init(cfg, device="cpu")
    for sp in params["stages"]:
        layer = M._layer(sp, 0)
        out = W.dequant_subtree(layer, torch.bfloat16)
        assert out is layer
        assert all(a is b for a, b in zip(T.leaves(out), T.leaves(layer)))
    assert W.dequant_subtree(params, torch.float32) is params


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "seamless_m4t_medium"])
def test_forward_dequantizes_only_trees_with_pairs(arch, monkeypatch):
    """The model looks for pairs once per stack and forward: a tree without
    pairs runs no dequantization (no walk per layer on the serving paths);
    under the 8-bit wire every layer body, the encoder's included,
    dequantizes its own slice once."""
    cfg = C.get_reduced(arch)
    params = M.init(cfg, device="cpu")
    calls = []
    dequant = W.dequant_subtree
    monkeypatch.setattr(W, "dequant_subtree", lambda t, dt: calls.append(1) or dequant(t, dt))
    batch = SyntheticLM(cfg, DATA).batch_at(0)
    with torch.no_grad():
        M.loss_fn(cfg, params, batch, device="cpu")
        assert calls == []
        pw = W.make_param_wire(dataclasses.replace(cfg, wire_bits=8))
        M.loss_fn(cfg, pw.graft(pw.quantize(params), pw.carrier(params)), batch, device="cpu")
    layers = sum(repeat for repeat, _ in M.stages(cfg)) + cfg.encoder_layers
    assert len(calls) == layers


def test_wire_moves_the_gradient_norm_as_the_reference():
    """In bf16 compute with the photonic numerics (the training path's
    flags), the 8-bit wire's int8 weights move the master gradient's norm
    away from the straight step's; the port's wire moves it as the
    reference's does, from the same weights and batch (reduced zamba2).
    Each norm within 2e-2: both sides round every bf16 product (the
    reference op by op), in different summation orders, over every layer;
    the ratio of the two seen here differs by 6e-3.  Compiled, the
    reference keeps bf16 products in f32 where a cast follows (module
    docstring) and its ratio moves by 3 %."""
    jcfg, jparams, specs, cfg, params = _pair("zamba2_1p2b")
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16", use_photonic_mac=True)
                 for c in (jcfg, cfg))
    batch = JSyntheticLM(jcfg, JDataConfig(global_batch=2, seq_len=64)).batch_at(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jpw = _ref_wire(jcfg, specs, 8)
    with jax.disable_jit():        # op by op: every bf16 product rounds (module docstring)
        jg0 = jax.grad(lambda p: JM.loss_fn(jcfg, p, jbatch)[0])(jparams)
        jq = jpw.quantize(jparams)
        jg8 = jax.grad(lambda v: JM.loss_fn(jcfg, jpw.graft(jq, v), jbatch)[0])(
            jpw.carrier(jparams))
    pw = W.make_param_wire(dataclasses.replace(cfg, wire_bits=8))
    p0, v = _requires_grad(params), _requires_grad(pw.carrier(params))
    g0 = torch.autograd.grad(M.loss_fn(cfg, p0, batch, device="cpu")[0], T.leaves(p0))
    g8 = torch.autograd.grad(M.loss_fn(cfg, pw.graft(pw.quantize(params), v), batch,
                                       device="cpu")[0], T.leaves(v))

    def norm(leaves):
        return float(np.sqrt(sum(float(np.sum(np.square(np.asarray(x, np.float64))))
                                 for x in leaves)))

    want = [norm(map(_jnp_np, jax.tree.leaves(t))) for t in (jg0, jg8)]
    got = [norm(map(_np, t)) for t in (g0, g8)]
    np.testing.assert_allclose(got, want, rtol=2e-2)
    np.testing.assert_allclose(got[1] / got[0], want[1] / want[0], rtol=2e-2)


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (24, 64, 40)])  # tiled; per-column
def test_photonic_matmul_of_bf16_weights_matches_reference(m, k, n, xdt):
    """Under the wire a linear receives bf16 weights (a dequantized pair or
    a `_quant_leaf` output), not f32 masters: the photonic product
    quantizes them in bf16 as the reference's op by op (the same levels,
    so the same output to the kernel's summation order), and its
    straight-through backward returns dw in bf16 and dx in x's dtype."""
    r = np.random.default_rng(0)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = (r.standard_normal((k, n)) * 0.05).astype(np.float32)
    g = r.standard_normal((m, n)).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(xdt), jnp.asarray(w).astype(jnp.bfloat16)
    y, vjp = jax.vjp(lambda a, b: JO.photonic_matmul(a, b, 8, True), jx, jw)
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).to(getattr(torch, xdt)).requires_grad_(True)
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    out = ops.photonic_matmul(tx, tw, 8, True)
    dx, dw = torch.autograd.grad(out, (tx, tw), torch.from_numpy(g))
    assert dw.dtype == torch.bfloat16 and dx.dtype == tx.dtype
    want = np.asarray(y, np.float32)
    np.testing.assert_allclose(_np(out), want, rtol=0, atol=1e-6 * float(np.abs(want).max()))
    for got, ref in ((dx, jdx), (dw, jdw)):
        ref = _jnp_np(ref)
        step = 2 ** -8 if got.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(_np(got), ref, rtol=step, atol=step * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# the wire on whole models
# ---------------------------------------------------------------------------

ARCHS = ["yi_6b", "zamba2_1p2b", "seamless_m4t_medium"]


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_wire_matches_reference(arch, bits):
    """`quantize`, `carrier` and `graft` on reduced yi-6b, zamba2 (mamba's
    stacked 2-D `A_log`, `D`, `dt_bias`; the non-stacked shared attention)
    and seamless (pairs under `encoder.blocks`): the same pair paths,
    levels and scales; the same carrier; every grafted non-pair leaf equal
    to the reference's (a stacked 2-D leaf through `_quant_leaf` with one
    scale for all its layers); then the loss at 1e-5 and every master
    gradient within one bf16 step of its norm."""
    jcfg, jparams, specs, cfg, params = _pair(arch)
    jpw = _ref_wire(jcfg, specs, bits)
    pw = W.make_param_wire(dataclasses.replace(cfg, wire_bits=bits))
    jq, q = jpw.quantize(jparams), pw.quantize(params)
    jflat = _named(jax.tree.map(np.asarray, jq))
    flat = dict(T.leaves_with_path(q))
    assert set(flat) == set(jflat)
    pairs = sorted(n for n in flat if n.endswith("['~q']"))
    if bits == 8:
        assert pairs, "no pair at 8 bits"
        assert all(n.startswith(("['stages']", "['encoder']['blocks']")) for n in pairs)
        if arch == "seamless_m4t_medium":
            assert any(n.startswith("['encoder']['blocks']") for n in pairs)
    else:
        assert not pairs
    for name, t in flat.items():
        assert t.dtype == getattr(torch, str(jflat[name].dtype)), name
        np.testing.assert_array_equal(_np(t), jflat[name].astype(np.float32), err_msg=name)
    jcar, car = jpw.carrier(jparams), pw.carrier(params)
    for (name, t), (jname, jt) in zip(T.leaves_with_path(car), _named(jcar).items()):
        assert name == jname
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt), err_msg=name)
    jgraft = _named(jpw.graft(jq, jcar))
    graft = dict(T.leaves_with_path(pw.graft(q, car)))
    assert set(graft) == set(jgraft)
    for name, t in graft.items():
        assert t.dtype == getattr(torch, str(jgraft[name].dtype)), name
        np.testing.assert_array_equal(_np(t), _jnp_np(jgraft[name]), err_msg=name)
    if bits == 8 and "['stages'][0]['attn_0']['attn']['norm']" in graft:
        # a stacked 2-D leaf: one scale for both layers (not a pair)
        norm = params["stages"][0]["attn_0"]["attn"]["norm"]
        want = W._quant_leaf(norm, 8, torch.bfloat16)
        assert torch.equal(graft["['stages'][0]['attn_0']['attn']['norm']"], want)

    batch = JSyntheticLM(jcfg, JDataConfig(global_batch=2, seq_len=64)).batch_at(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jg = jax.value_and_grad(
        lambda v: JM.loss_fn(jcfg, jpw.graft(jq, v), jbatch), has_aux=True)(jcar)
    v = _requires_grad(car)
    loss, _ = M.loss_fn(cfg, pw.graft(q, v), batch, device="cpu")
    g = torch.autograd.grad(loss, T.leaves(v), allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    names = [n for n, _ in T.leaves_with_path(v)]
    _assert_grads_close(dict(zip(names, g)), _named(jax.tree.map(np.asarray, jg)), (arch, bits))


def test_param_wire_refuses_a_mesh():
    """A mesh without the rules and specs its shards are laid out by (the
    reference's factory takes all three)."""
    cfg = C.get_reduced("yi_6b")
    with pytest.raises(ValueError, match="mesh"):
        W.make_param_wire(cfg, mesh=object())
    assert W.make_param_wire(cfg).bits == 0


def test_wire_grads_close_to_master_on_the_port():
    """The reference test's bars (`test_wire_grads_close_to_master`) on the
    port: reduced yi-6b, B=2 x 64, the wire's master gradients within 0.05
    (16 bits) and 0.25 (8 bits) of the f32 masters' in norm, leaf by leaf."""
    _, _, _, cfg, params = _pair("yi_6b")
    batch = {"tokens": np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0, cfg.vocab)),
             "labels": np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 64), 0, cfg.vocab))}
    p0 = _requires_grad(params)
    g0 = torch.autograd.grad(M.loss_fn(cfg, p0, batch, device="cpu")[0], T.leaves(p0))
    for bits, tol in ((16, 0.05), (8, 0.25)):
        pw = W.make_param_wire(dataclasses.replace(cfg, wire_bits=bits))
        q = pw.quantize(params)
        v = _requires_grad(pw.carrier(params))
        g = torch.autograd.grad(M.loss_fn(cfg, pw.graft(q, v), batch, device="cpu")[0],
                                T.leaves(v))
        for a, b in zip(g0, g):
            na = float(torch.linalg.norm(a))
            nd = float(torch.linalg.norm(a - b))
            assert nd <= tol * na + 1e-6, (bits, nd, na)


def test_wire_format_training_converges_on_the_port():
    """The reference test's bars (`test_wire_format_training_converges`) on
    the port: 12 steps of reduced yi-6b under the 8-bit wire learn, beat
    the untrained loss, and end within 1.5x + 0.5 of the f32 run."""
    _, _, _, cfg, params = _pair("yi_6b")
    cfg8 = dataclasses.replace(cfg, wire_bits=8)
    src = SyntheticLM(cfg, DATA)

    def run(c, pw):
        step = TR.make_train_step(c, OPT, param_wire=pw, device="cpu")
        st = adamw.init_state(OPT, T.map_structure(torch.clone, params))
        losses = []
        for i in range(12):
            st, m = step(st, TR._to_device(src.batch_at(i), torch.device("cpu")))
            losses.append(float(m["loss"]))
        return losses

    base = run(cfg, None)
    quant = run(cfg8, W.make_param_wire(cfg8))
    assert base[-1] < base[0]
    assert quant[-1] < quant[0]
    assert quant[-1] < base[0]
    assert quant[-1] < base[-1] * 1.5 + 0.5


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_under_the_wire_matches_reference(accum):
    """`make_train_step(param_wire=)` against the reference's from one
    state, at `accum_steps` 1 and 2: loss and ce at 1e-5, the gradient norm
    at 2^-8, and the gradients the step hands AdamW (its first moment after
    step 1, 0.1 x the clipped gradient) leaf by leaf within one bf16 step
    of their norm, in the master tree's structure."""
    jcfg, jparams, specs, cfg, _ = _pair("zamba2_1p2b")
    jcfg8, cfg8 = (dataclasses.replace(c, wire_bits=8) for c in (jcfg, cfg))
    jstate = JA.init_state(JOPT, jparams)
    state = state_from_reference(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    batch = JSyntheticLM(jcfg, JDataConfig(global_batch=4, seq_len=64)).batch_at(0)
    with jax.disable_jit():        # op by op: every bf16 product rounds (module docstring)
        jnew, jm = JT.make_train_step(jcfg8, JOPT, param_wire=_ref_wire(jcfg, specs, 8),
                                      accum_steps=accum)(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = TR.make_train_step(cfg8, OPT, param_wire=W.make_param_wire(cfg8), accum_steps=accum,
                                device="cpu")(state, TR._to_device(batch, torch.device("cpu")))
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=GRAD_NORM_RTOL)
    got = dict(T.leaves_with_path(new.m))
    want = {n: np.asarray(v) for n, v in _named(jnew.m).items()}
    _assert_grads_close(got, want, ("accum", accum))
    assert set(dict(T.leaves_with_path(new.params))) == set(_named(jnew.params))
