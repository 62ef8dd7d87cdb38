"""The sharded train step's tensor-parallel split on `model`, its photonic
dispatch on the global batch, and the parameter wire over a mesh, against
the JAX package's GSPMD step at 8 ranks on the CPU.

Cases (`CASES`), each two steps from the reference's initial weights on
(pod 2, data 2, model 2), against the reference's compiled sharded step
(jit with the state and batch shardings under `activation_sharding`, on a
mesh of `AxisType.Auto` axes) at `REF_STEP_TOL`, and against the port's
one-device step at the tolerances of `tests/test_torch_sharded_train.py`:

  * `yi_6b-photonic`: `MEMORY_CFG`'s yi-6b (8 layers at d_model 512) with
    photonic numerics, the reference's plain path (`use_kernel=False`), 4
    x 64 tokens: 256 global rows take the tiled per-bank path, while a
    rank holds 64 (the fault this file was written against: a rank that
    decides on its own rows takes the per-column path, other numbers by
    design).  Its `wk` and `wv` are one 128-column bank, split in two
    64-column halves at model 2: each half is quantized with the whole
    bank's scale (a MAX over the split);
  * `yi_6b-photonic-banks`: a yi-6b of 128-wide products (`PHOTONIC_BANKS`)
    with photonic numerics: `wk`, `wv` and `wo` straddle a bank at model
    2;
  * `yi_6b-head_dim`: 3 heads, which do not split 2 ways: the rules shard
    `head_dim`, and the attention is computed whole on every `model` rank;
  * `yi_6b-seq_tp`: attention on a slice of the sequence, MLP and head
    split by `ffn` and vocabulary;
  * `yi_6b-fsdp_all`: 8 sequences, the batch over the whole mesh, `model`
    included: no split;
  * `mixtral_8x7b-ffn` in both dispatch modes: 3 experts, which do not
    split 2 ways, so each expert's `ffn` splits (mixtral's and grok-1's
    layout at the production mesh's model 16);
  * `yi_6b-wire8`: the 8-bit parameter wire over the mesh, one step, the
    reference's wire over the same Auto-axis mesh run op by op
    (`jax.disable_jit()`: compiled, XLA keeps bf16 products unrounded,
    `tests/test_torch_wire.py`), at that file's tolerances: the loss at
    1e-5, the norm at 2^-8, the first moment (0.1 x the clipped gradient)
    leaf by leaf within one bf16 step of its norm.

Against the reference, every case but the wire's holds the loss and the
norm on every rank, both steps' first moments leaf by leaf, and the
updated parameters at the entries `_held` keeps: all but those whose
reference gradient in a step is near nought but not nought, which AdamW
turns into updates of order lr either way.  Against the one-device step
(`ONE_DEVICE_CASES`), every parameter.

The configs of `tests/test_torch_sharded_train.py`'s `STEP_CASES` run the
split there, against the same reference step; here each one's work per
rank: `torch.utils.flop_counter.FlopCounterMode` over one step, forward,
recomputation and backward, against the one-device step at the rank's
batch shard (what every `model` rank computed before the split).  On
`MEMORY_CFG`'s yi-6b a rank's count is at most `FLOP_SHARE` x the
one-device step at the global batch / 8.

The wire over the mesh: reduced yi-6b and zamba2 (its shared attention a
3-D leaf with one scale per leading index, split over `data`) at 8 and 16
bits against the port's one-device wire, and the bytes handed to
`all_gather` in a step: at 8 bits no f32 crosses, and every byte is at most
`WIRE_BYTE_SHARE` x the f32 step's.

In this process: the padded shard product (`ops.shard_banks`) against the
global product's columns and rows, and which leaves each config splits at
the test mesh and at the production mesh (16, 16).

One module fixture runs the reference subprocess and the 8 port ranks
together (`test_torch_distributed._run_both`); the test process imports
no jax.
"""

import dataclasses
import json
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch import tree as T
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as S
from repro_torch.parallel.collectives import MeshGeometry
from repro_torch.runtime import trainer as TR
from test_torch_distributed import _run_both
from test_torch_sharded_train import MEMORY_CFG, OPT_KW, REF_STEP_TOL, STEP_CASES

WORLD = 8
TIMEOUT_S = 600
STEPS = 2
# a yi-6b whose every product tiles at 4 x 64 tokens: `wq` (4 heads of 64)
# is 128 columns a rank, `wk`, `wv` (2 KV heads) one bank halved, `wo` 128
# rows halved, the MLP 128 `ffn` columns a rank
PHOTONIC_BANKS = dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=256)
# name -> (config, its replaced fields, global batch, steps)
CASES = {
    "yi_6b-photonic": ("yi_6b", dict(MEMORY_CFG, use_photonic_mac=True), 4, STEPS),
    "yi_6b-photonic-banks": ("yi_6b", dict(PHOTONIC_BANKS, use_photonic_mac=True), 4, STEPS),
    "yi_6b-head_dim": ("yi_6b", dict(n_heads=3), 4, STEPS),
    "yi_6b-seq_tp": ("yi_6b", dict(parallel_strategy="seq_tp"), 4, STEPS),
    "yi_6b-fsdp_all": ("yi_6b", dict(parallel_strategy="fsdp_all"), 8, STEPS),
    "mixtral_8x7b-ffn": ("mixtral_8x7b", dict(n_experts=3), 4, STEPS),
    "mixtral_8x7b-ffn-index": ("mixtral_8x7b", dict(n_experts=3, moe_dispatch="index"), 4,
                               STEPS),
    "yi_6b-wire8": ("yi_6b", dict(wire_bits=8), 4, 1),
}
WIRE_CASES = ("yi_6b-wire8",)
SEQ = 64
# the port's sharded step against its one-device step
# (`tests/test_torch_sharded_train.py`)
PLAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "params_rtol": 2e-4, "params_atol": 2e-5}
# the wire's (`tests/test_torch_wire.py`)
WIRE_LOSS_RTOL, WIRE_GRAD_RTOL = 1e-5, 2 ** -8
# the wire over the mesh against the one-device wire: a leaf's gradient
# reaches f32 from bf16 on each of the 4 batch ranks, each rank's part
# rounded apart before the sum, so one bf16 step for each
WIRE_MESH_GRAD_RTOL = 4 * 2 ** -8
# work per rank on MEMORY_CFG's yi-6b: at most this share of the one-device
# step at the global batch over the 8 ranks
FLOP_SHARE = 1.2
# the wire over the mesh against the port's one-device wire, and its bytes
WIRE_PORT = [(a, b) for a in ("yi_6b", "zamba2_1p2b") for b in (8, 16)]
WIRE_BYTE_SHARE = {8: 0.3, 16: 0.55}
# what rank 0 alone keeps of the cases' whole parameters and moments
WHOLE_KEYS = ("moment0|", "stepped|", "plain_stepped|", "moment|")


def case_cfg(case: str):
    arch, repl, _, _ = CASES[case]
    return dataclasses.replace(C.get_reduced(arch), **repl)


def step_case_cfg(case: str):
    arch, dispatch, _ = STEP_CASES[case]
    return dataclasses.replace(C.get_reduced(arch), moe_dispatch=dispatch)


def _batch(cfg, b: int):
    return SyntheticLM(cfg, DataConfig(global_batch=b, seq_len=SEQ)).batch_at(0)


REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro import configs as C
    from repro.models import model as M
    from repro.optim import adamw
    from repro.parallel import actx
    from repro.parallel import sharding as S
    from repro.parallel import wire as Wr
    from repro.runtime.trainer import make_train_step

    tmp = sys.argv[1]
    setup = json.loads(open(f"{tmp}/setup.json").read())
    inp = dict(np.load(f"{tmp}/inputs.npz"))
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
    keystr = jax.tree_util.keystr
    cfgs = {case: dataclasses.replace(C.get_reduced(arch), **repl)
            for case, (arch, repl, _, _) in setup["cases"].items()}
    inits = {case: M.init(cfg, jax.random.PRNGKey(0)) for case, cfg in cfgs.items()}
    np.savez(f"{tmp}/init.tmp.npz", **{f"{case}|{keystr(k)}": np.asarray(v)
                                        for case, (p, _) in inits.items()
                                        for k, v in jax.tree_util.tree_leaves_with_path(p)})
    os.replace(f"{tmp}/init.tmp.npz", f"{tmp}/ref_init.npz")
    arrays = {}
    for case, (arch, repl, b, steps) in setup["cases"].items():
        cfg = cfgs[case]
        params, pspecs = inits[case]
        rules = S.rules_for(cfg, mesh)
        opt = adamw.OptConfig(**setup["opt"])
        state = adamw.init_state(opt, params)
        state_sh = S.enforce_divisibility(
            S.tree_shardings(mesh, adamw.state_specs(pspecs), rules),
            jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state))
        batch = {k[len(case) + 7:]: jnp.asarray(v) for k, v in inp.items()
                 if k.startswith(f"batch|{case}|")}
        batch_sh = S.train_batch_shardings(cfg, mesh, batch)
        dp = S.batch_axes(mesh, b, cfg.parallel_strategy)
        with mesh, actx.activation_sharding(mesh, dp, seq_tp=cfg.parallel_strategy == "seq_tp"):
            if case in setup["wire_cases"]:
                # op by op: every bf16 product rounds, as the port's do
                pw = Wr.make_param_wire(cfg, mesh, rules, pspecs)
                with jax.disable_jit():
                    for i in range(steps):
                        state, m = make_train_step(cfg, opt, param_wire=pw)(
                            jax.device_put(state, state_sh), jax.device_put(batch, batch_sh))
                        for name, val in m.items():
                            arrays[f"step|{case}|{i}|{name}"] = np.asarray(val)
            else:
                step = jax.jit(make_train_step(cfg, opt), in_shardings=(state_sh, batch_sh))
                for i in range(steps):
                    state, m = step(jax.device_put(state, state_sh),
                                    jax.device_put(batch, batch_sh))
                    for name, val in m.items():
                        arrays[f"step|{case}|{i}|{name}"] = np.asarray(val)
                    if i == 0:
                        for k, v in jax.tree_util.tree_leaves_with_path(state.m):
                            arrays[f"moment0|{case}|{keystr(k)}"] = np.asarray(v)
        for k, v in jax.tree_util.tree_leaves_with_path(state.params):
            arrays[f"stepped|{case}|{keystr(k)}"] = np.asarray(v)
        for k, v in jax.tree_util.tree_leaves_with_path(state.m):
            arrays[f"moment|{case}|{keystr(k)}"] = np.asarray(v)
    np.savez(f"{tmp}/ref.npz", **arrays)
""")

RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, os, sys, time
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    rank, world, tmp, tests = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    sys.path.insert(0, tests)
    from test_torch_tensor_parallel import (CASES, OPT_KW, WHOLE_KEYS, WIRE_PORT, _batch,
                                            case_cfg, step_case_cfg)
    from test_torch_sharded_train import MEMORY_CFG, STEP_CASES
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as C
    from repro_torch import tree as T
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as CC
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import wire as W
    from repro_torch.runtime import trainer as TR

    mesh = make_test_mesh(data=2, model=2, pod=2, device_type="cpu")
    opt = adamw.OptConfig(**OPT_KW)
    cpu = torch.device("cpu")
    out = {"coord": np.array(mesh.get_coordinate())}

    def tensors(batch):
        return {k: torch.as_tensor(v) for k, v in batch.items()}

    def flops(fn):
        with FlopCounterMode(display=False) as fc:
            fn()
        return fc.get_total_flops()

    def one_device(cfg, accum=1):
        pw = W.make_param_wire(cfg) if cfg.wire_bits else None
        return TR.make_train_step(cfg, opt, param_wire=pw, accum_steps=accum, device="cpu")

    def local_batch(batch_sh, batch):
        return {k: S.local_shard(mesh, batch_sh[k].spec, v) for k, v in batch.items()}

    # the work per rank of every STEP_CASES config: one sharded step, and
    # the one-device step on the rank's batch shard (the step before the
    # split: each `model` rank computed that)
    for case, (_, _, accum) in STEP_CASES.items():
        cfg = step_case_cfg(case)
        params = M.init(cfg, seed=0, device="cpu", expert_dtype=torch.float32)
        batch = tensors(_batch(cfg, 4 * accum))
        step, sh, bsh = TR.build_sharded_step(cfg, opt, mesh, M.param_specs(cfg), batch,
                                              device="cpu", accum_steps=accum)
        state = TR.distribute(mesh, adamw.init_state(opt, params), sh)
        out[f"work|{case}"] = np.array(flops(lambda: step(state, batch)))
        mine = local_batch(bsh, batch)
        out[f"work_unsplit|{case}"] = np.array(flops(
            lambda: one_device(cfg, accum)(adamw.init_state(opt, params), mine)))
        out[f"split_leaves|{case}"] = np.array(sum(TR.tp_split_leaves(
            cfg, mesh, ("pod", "data"), T.leaves(sh.params))))

    # MEMORY_CFG's yi-6b: a rank's work against the global step's / 8
    mcfg = dataclasses.replace(C.get_reduced("yi_6b"), **MEMORY_CFG)
    mparams = M.init(mcfg, seed=0, device="cpu")
    mbatch = tensors(_batch(mcfg, 4))
    mstep, msh, mbsh = TR.build_sharded_step(mcfg, opt, mesh, M.param_specs(mcfg), mbatch,
                                             device="cpu")
    mstate = TR.distribute(mesh, adamw.init_state(opt, mparams), msh)
    out["flops_rank"] = np.array(flops(lambda: mstep(mstate, mbatch)))
    out["flops_unsplit_rank"] = np.array(flops(
        lambda: one_device(mcfg)(adamw.init_state(opt, mparams), local_batch(mbsh, mbatch))))
    if rank == 0:
        out["flops_global"] = np.array(flops(
            lambda: one_device(mcfg)(adamw.init_state(opt, mparams), mbatch)))
    del mstate, mparams

    # the wire over the mesh against the port's one-device wire, and the
    # bytes every all_gather of a step is handed, by dtype
    # (the parameter gather's: TRINE's all-gather of the replicated
    # leaves' gradient is not counted)
    gathered, inside = {}, []
    plain_gather, plain_shards = CC.all_gather, CC.gather_shards

    def counting(x, group):
        if inside:
            key = str(x.dtype).replace("torch.", "")
            gathered[key] = gathered.get(key, 0) + x.numel() * x.element_size()
        return plain_gather(x, group)

    def shards(*args):
        inside.append(1)
        try:
            return plain_shards(*args)
        finally:
            inside.pop()

    for arch, bits in WIRE_PORT + [(a, 0) for a in sorted({a for a, _ in WIRE_PORT})]:
        cfg = dataclasses.replace(C.get_reduced(arch), wire_bits=bits)
        params = M.init(cfg, seed=0, device="cpu")
        batch = tensors(_batch(cfg, 4))
        step, sh, _ = TR.build_sharded_step(cfg, opt, mesh, M.param_specs(cfg), batch,
                                            device="cpu")
        state = TR.distribute(mesh, adamw.init_state(opt, params), sh)
        gathered.clear()
        CC.all_gather, CC.gather_shards = counting, shards
        try:
            state, m = step(state, batch)
        finally:
            CC.all_gather, CC.gather_shards = plain_gather, plain_shards
        for k, v in gathered.items():
            out[f"bytes|{arch}|{bits}|{k}"] = np.array(v)
        if bits:
            pstate, pm = one_device(cfg)(adamw.init_state(opt, params), batch)
            for name in ("loss", "ce", "grad_norm"):
                out[f"wire|{arch}|{bits}|{name}"] = m[name]
                out[f"wire_plain|{arch}|{bits}|{name}"] = pm[name]
            for n, t in T.leaves_with_path(TR.gather(state.m)):
                out[f"wire_moment|{arch}|{bits}|{n}"] = t
            for n, t in T.leaves_with_path(pstate.m):
                out[f"wire_plain_moment|{arch}|{bits}|{n}"] = t

    # the cases against the reference: from its initial weights
    deadline = time.time() + 540
    while not os.path.exists(f"{tmp}/ref_init.npz"):
        assert time.time() < deadline, "the reference wrote no initial weights"
        time.sleep(0.2)
    ref = np.load(f"{tmp}/ref_init.npz")
    inp = np.load(f"{tmp}/inputs.npz")
    for case, (_, _, b, steps) in CASES.items():
        cfg = case_cfg(case)
        like, _ = M.init_abstract(cfg)
        params = T.unflatten(like, [torch.from_numpy(ref[f"{case}|{n}"])
                                    for n, _ in T.leaves_with_path(like)])
        batch = {k[len(case) + 7:]: torch.from_numpy(v) for k, v in inp.items()
                 if k.startswith(f"batch|{case}|")}
        step, sh, bsh = TR.build_sharded_step(cfg, opt, mesh, M.param_specs(cfg), batch,
                                              device="cpu")
        out[f"split_leaves|{case}"] = np.array(sum(TR.tp_split_leaves(
            cfg, mesh, bsh["tokens"].spec[0], T.leaves(sh.params))))
        state = TR.distribute(mesh, adamw.init_state(opt, params), sh)
        plain, pstate = one_device(cfg), adamw.init_state(opt, params)
        # the whole parameters and moments: gathered on every rank, kept
        # by rank 0 (the tests read them there)
        for i in range(steps):
            state, m = step(state, batch)
            pstate, pm = plain(pstate, batch)
            for name in m:
                out[f"step|{case}|{i}|{name}"] = m[name]
                out[f"plain|{case}|{i}|{name}"] = pm[name]
            if i == 0 and steps > 1:
                # a copy: the next step updates a replicated leaf in place
                for n, t in T.leaves_with_path(TR.gather(state.m)):
                    out[f"moment0|{case}|{n}"] = t.clone()
        for n, t in T.leaves_with_path(TR.gather(state.params)):
            out[f"stepped|{case}|{n}"] = t
        for n, t in T.leaves_with_path(pstate.params):
            out[f"plain_stepped|{case}|{n}"] = t
        for n, t in T.leaves_with_path(TR.gather(state.m)):
            out[f"moment|{case}|{n}"] = t
        if rank:
            out = {k: v for k, v in out.items() if not k.startswith(WHOLE_KEYS)}
    np.savez(f"{tmp}/port_{rank}.npz",
             **{k: v.detach().numpy() if torch.is_tensor(v) else v for k, v in out.items()})
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tensor_parallel")
    inputs = {}
    for case, (_, _, b, _) in CASES.items():
        for k, v in _batch(case_cfg(case), b).items():
            inputs[f"batch|{case}|{k}"] = v
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "setup.json").write_text(json.dumps({
        "cases": CASES, "opt": OPT_KW, "wire_cases": list(WIRE_CASES)}))
    _run_both(tmp, REF_SCRIPT, RANK_SCRIPT, TIMEOUT_S)
    return {"ref": dict(np.load(tmp / "ref.npz")),
            "ranks": [dict(np.load(tmp / f"port_{r}.npz")) for r in range(WORLD)]}


def _metric(got, kind, case, i, name):
    return float(got[f"{kind}|{case}|{i}|{name}"])


def _close_in_norm(got, want, rtol, what):
    nd = float(np.linalg.norm(np.asarray(got, np.float32) - np.asarray(want, np.float32)))
    assert nd <= rtol * float(np.linalg.norm(np.asarray(want, np.float32))) + 1e-12, (what, nd)


def test_global_batch_decides_the_photonic_path(runs):
    """256 global rows, 64 a rank: the step quantizes as the reference's
    compiled step does on the global batch (the tiled per-bank path), so
    the loss and the gradient norm of both steps agree within
    `REF_STEP_TOL` on every rank, and with the port's one-device step."""
    ref, case = runs["ref"], "yi_6b-photonic"
    for got in runs["ranks"]:
        for i in range(STEPS):
            for name in ("loss", "grad_norm"):
                np.testing.assert_allclose(_metric(got, "step", case, i, name),
                                           float(ref[f"step|{case}|{i}|{name}"]),
                                           rtol=REF_STEP_TOL[name], err_msg=f"{i} {name}")
                np.testing.assert_allclose(_metric(got, "step", case, i, name),
                                           _metric(got, "plain", case, i, name),
                                           rtol=PLAIN_TOL[name], err_msg=f"{i} {name}")
    assert ops.uses_tiled_path(4 * SEQ, MEMORY_CFG["d_model"], MEMORY_CFG["d_ff"])
    assert not ops.uses_tiled_path(SEQ, MEMORY_CFG["d_model"], MEMORY_CFG["d_ff"])


# every case but the wire's (held op by op below)
REF_CASES = [c for c in CASES if c not in WIRE_CASES]
# against the port's one-device step, parameters at `PLAIN_TOL`: all but
# A's, whose one-device step sums the row-parallel products in another
# order, so near-nought gradients tip a few AdamW updates (held there by
# loss and norm, `test_global_batch_decides_the_photonic_path`)
ONE_DEVICE_CASES = [c for c in REF_CASES if c != "yi_6b-photonic"]
# a parameter entry is held against the reference's where each step's
# reference gradient (from its first moments) is nought or at least
# GRAD_NOISE x that gradient's RMS over the leaf.  AdamW's first updates
# are about lr x sign(g), so a gradient nearer nought than the two steps'
# rounding differences (under photonic numerics a level that rounds the
# other way) moves its entry by up to lr.  The moments are held at every
# entry, leaf by leaf in norm at REF_STEP_TOL's gradient-norm tolerance
GRAD_NOISE = 1e-2


def _held(ref, case: str, name: str) -> np.ndarray:
    """The entries of leaf `name` whose reference gradients, both steps',
    are nought or above `GRAD_NOISE` x their RMS over the leaf."""
    b1 = adamw.OptConfig(**OPT_KW).b1
    m0 = ref[f"moment0|{case}|{name}"].astype(np.float64)
    m1 = ref[f"moment|{case}|{name}"].astype(np.float64)
    held = np.ones(m0.shape, bool)
    for g in (m0 / (1 - b1), (m1 - b1 * m0) / (1 - b1)):
        rms = float(np.sqrt(np.mean(g ** 2))) if g.size else 0.0
        held &= (g == 0) | (np.abs(g) >= GRAD_NOISE * rms)
    return held


@pytest.mark.parametrize("case", REF_CASES)
def test_split_step_matches_the_references_compiled_step(runs, case):
    """Two steps against the reference's jitted sharded step, at the
    unchanged `REF_STEP_TOL`: loss and gradient norm on every rank, both
    steps' first moments leaf by leaf, and the updated parameters at the
    entries `_held` keeps.  Prints the largest parameter difference held
    (in lr) and the share of entries left out."""
    ref = runs["ref"]
    for got in runs["ranks"]:
        for i in range(STEPS):
            for name in ("loss", "grad_norm"):
                np.testing.assert_allclose(_metric(got, "step", case, i, name),
                                           float(ref[f"step|{case}|{i}|{name}"]),
                                           rtol=REF_STEP_TOL[name], err_msg=f"{i} {name}")
    got, atol = runs["ranks"][0], REF_STEP_TOL["params_lr"] * OPT_KW["lr"]
    keys = [k for k in got if k.startswith(f"stepped|{case}|")]
    assert len(keys) == len([k for k in ref if k.startswith(f"stepped|{case}|")])
    worst, left_out, size = 0.0, 0, 0
    for key in keys:
        name = key.split("|", 2)[2]
        for moment in ("moment0", "moment"):
            mkey = f"{moment}|{case}|{name}"
            _close_in_norm(got[mkey], ref[mkey], REF_STEP_TOL["grad_norm"], mkey)
        held = _held(ref, case, name)
        np.testing.assert_allclose(got[key][held], ref[key][held],
                                   rtol=REF_STEP_TOL["params_rtol"], atol=atol, err_msg=key)
        if held.any():
            diff = np.abs(got[key][held].astype(np.float64) - ref[key][held])
            worst = max(worst, float(diff.max()) / OPT_KW["lr"])
        left_out, size = left_out + int(held.size - held.sum()), size + held.size
    print(f"{case}: parameters within {worst:.3g} lr of the reference's, "
          f"{left_out} of {size} entries left out")


@pytest.mark.parametrize("case", ONE_DEVICE_CASES)
def test_split_step_matches_the_one_device_step(runs, case):
    """The same two steps against the port's one-device step from the same
    state; and the split takes (or, under `fsdp_all` and where `head_dim`
    carries the model axis, leaves) the leaves it should."""
    got = runs["ranks"][0]
    for i in range(STEPS):
        for name in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(_metric(got, "step", case, i, name),
                                       _metric(got, "plain", case, i, name),
                                       rtol=PLAIN_TOL["loss" if name != "grad_norm" else name],
                                       err_msg=f"{i} {name}")
    for key in [k for k in got if k.startswith(f"stepped|{case}|")]:
        np.testing.assert_allclose(got[key], got["plain_" + key], rtol=PLAIN_TOL["params_rtol"],
                                   atol=PLAIN_TOL["params_atol"], err_msg=key)
    split = int(got[f"split_leaves|{case}"])
    if case == "yi_6b-fsdp_all":
        assert split == 0
    else:
        # the MLP (or experts' ffn), the embedding and the head at least;
        # the attention too unless its heads do not split
        assert split >= 5, split


def test_the_wire_over_the_mesh_matches_the_references(runs):
    """One step of reduced yi-6b under the 8-bit wire over the mesh against
    the reference's wire on the same Auto-axis mesh, op by op: the loss at
    1e-5, the norm at 2^-8, the first moment leaf by leaf within one bf16
    step of its norm."""
    ref, got = runs["ref"], runs["ranks"][0]
    case = "yi_6b-wire8"
    for name in ("loss", "ce"):
        np.testing.assert_allclose(_metric(got, "step", case, 0, name),
                                   float(ref[f"step|{case}|0|{name}"]), rtol=WIRE_LOSS_RTOL)
    np.testing.assert_allclose(_metric(got, "step", case, 0, "grad_norm"),
                               float(ref[f"step|{case}|0|grad_norm"]), rtol=WIRE_GRAD_RTOL)
    keys = [k for k in got if k.startswith(f"moment|{case}|")]
    assert keys and len(keys) == len([k for k in ref if k.startswith(f"moment|{case}|")])
    for key in keys:
        _close_in_norm(got[key], ref[key], WIRE_GRAD_RTOL, key)


@pytest.mark.parametrize("arch, bits", WIRE_PORT)
def test_the_wire_over_the_mesh_matches_the_one_device_wire(runs, arch, bits):
    """The wire over the mesh against the port's one-device wire, one step:
    the loss at 1e-5, the norm at 2^-8, the first moment leaf by leaf
    within `WIRE_MESH_GRAD_RTOL` of its norm (at 16 bits zamba2's `dt_bias`,
    a sum of cancelling terms, is 0.48 % off)."""
    got = runs["ranks"][0]
    for name in ("loss", "ce"):
        np.testing.assert_allclose(float(got[f"wire|{arch}|{bits}|{name}"]),
                                   float(got[f"wire_plain|{arch}|{bits}|{name}"]),
                                   rtol=WIRE_LOSS_RTOL)
    np.testing.assert_allclose(float(got[f"wire|{arch}|{bits}|grad_norm"]),
                               float(got[f"wire_plain|{arch}|{bits}|grad_norm"]),
                               rtol=WIRE_GRAD_RTOL)
    keys = [k for k in got if k.startswith(f"wire_moment|{arch}|{bits}|")]
    assert keys
    for key in keys:
        _close_in_norm(got[key], got[key.replace("wire_moment", "wire_plain_moment")],
                       WIRE_MESH_GRAD_RTOL, key)


@pytest.mark.parametrize("bits", sorted(WIRE_BYTE_SHARE))
def test_the_wire_shrinks_what_the_gather_moves(runs, bits):
    """The bytes handed to `all_gather` in one step, on every rank: under
    the wire at most `WIRE_BYTE_SHARE` of the f32 step's, and at 8 bits no
    f32 at all (the `~d` carrier never crosses)."""
    for got in runs["ranks"]:
        for arch in sorted({a for a, _ in WIRE_PORT}):
            f32 = sum(int(v) for k, v in got.items() if k.startswith(f"bytes|{arch}|0|"))
            wired = {k.rsplit("|", 1)[1]: int(v) for k, v in got.items()
                     if k.startswith(f"bytes|{arch}|{bits}|")}
            assert f32 > 0 and sum(wired.values()) <= WIRE_BYTE_SHARE[bits] * f32, (arch, wired)
            if bits == 8:
                assert set(wired) == {"int8"}, (arch, wired)


def test_a_ranks_work_is_an_eighth_of_the_step(runs):
    """MEMORY_CFG's yi-6b at (2, 2, 2), 4 x 64: a rank's FLOPs (forward,
    recomputation, backward) at most `FLOP_SHARE` x the one-device step's at
    the global batch / 8; the step before the split (the one-device step
    on the rank's batch shard) did twice that."""
    whole = int(runs["ranks"][0]["flops_global"])
    for got in runs["ranks"]:
        rank, unsplit = int(got["flops_rank"]), int(got["flops_unsplit_rank"])
        assert rank <= FLOP_SHARE * whole / WORLD, (rank, whole / WORLD)
        assert unsplit >= 1.8 * whole / WORLD, (unsplit, whole / WORLD)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_the_split_cuts_each_configs_work(runs, case):
    """Every `STEP_CASES` config (whose sharded step
    `tests/test_torch_sharded_train.py` holds to the reference's): a rank's
    FLOPs in one step below the one-device step's on its batch shard, the
    same on every rank."""
    first = runs["ranks"][0]
    for got in runs["ranks"]:
        assert int(got[f"split_leaves|{case}"]) > 0
        assert int(got[f"work|{case}"]) == int(first[f"work|{case}"])
        assert int(got[f"work|{case}"]) < int(got[f"work_unsplit|{case}"]), case


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


def _bank_max_over(w: torch.Tensor):
    """A `reduce_max` for one process holding the whole weight `w`: the
    MAX over every rank's grid is the whole weight's banks' maxima."""
    grid = ops.bank_absmax(w)
    return lambda t: grid


@pytest.mark.parametrize("split, index, per_column", [
    ("cols", 1, False), ("cols", 2, False), ("rows", 1, False), ("rows", 1, True)])
def test_a_padded_shard_is_the_global_products_slice(split, index, per_column):
    """yi-6b's `ffn` of 11008 at model 16 (688 columns a rank, straddling
    banks) at K = 256: a column slice's product equals those columns of the
    global product bit for bit, with the levels and scales of the global
    weight; a row slice's partial products (here all 16) sum to it.  On
    the per-column path (64 rows, not a multiple of 128) too."""
    rng = np.random.default_rng(index)
    parts = 16
    k, n, m = 256, 11008, (64 if per_column else 128)
    if split == "rows":
        k, n = 11008, 256
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    whole = ops.photonic_matmul(x, w, 8, False)
    reduce_max = _bank_max_over(w)
    if per_column:
        col = torch.linalg.vector_norm(w, ord=float("inf"), dim=0)
        reduce_max = lambda t: col                      # noqa: E731
    if split == "cols":
        size = n // parts
        part = w[:, index * size:(index + 1) * size]
        got = ops.photonic_matmul(x, part, 8, False,
                                  ops.Shard(m, "cols", index, parts, reduce_max))
        assert torch.equal(got, whole[:, index * size:(index + 1) * size])
        return
    size = k // parts
    total = sum(ops.photonic_matmul(x[:, r * size:(r + 1) * size], w[r * size:(r + 1) * size],
                                    8, False, ops.Shard(m, "rows", r, parts, reduce_max))
                for r in range(parts))
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-4 * float(whole.abs().max()))


def test_which_leaves_each_config_splits():
    """At the test mesh's model 2 and the production mesh's model 16
    (geometries: no process group), leaf by leaf, the split follows the
    rules: the attention by heads where they divide (never under the
    `head_dim` fallback: yi-34b's 56 heads at 16), the MLP by `ffn`, MoE by
    experts or, where they do not divide, by `ffn`, the embedding and head
    by vocabulary where it divides (never seamless's 256206), and the
    recurrent blocks never."""
    for shape, names in (((2, 2, 2), ("pod", "data", "model")), ((16, 16), ("data", "model"))):
        geo = MeshGeometry(shape, names)
        tp = dict(zip(names, shape))["model"]
        for arch in C.ARCH_IDS:
            cfg = C.get(arch)
            shapes, specs = M.init_abstract(cfg)
            sh = S.enforce_divisibility(S.tree_shardings(geo, specs, S.rules_for(cfg, geo)),
                                        shapes)
            split = dict(zip([n for n, _ in T.leaves_with_path(shapes)],
                             TR.tp_split_leaves(cfg, geo, ("data",), T.leaves(sh))))
            for name, on in split.items():
                leaf = name.rsplit("'", 2)[-2]
                group = name.split("']['")[-2] if "']['" in name else ""
                if name.startswith("['stages']") and group in ("mamba", "mlstm", "slstm"):
                    want = False
                elif group in ("attn", "cross") or name.startswith("['shared_attn']"):
                    want = (cfg.n_heads % tp == 0 and leaf in ("wq", "wo")) or (
                        cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
                        and leaf in ("wk", "wv"))
                elif group == "mlp":
                    want = leaf != "norm" and cfg.d_ff % tp == 0
                elif group == "moe":
                    want = leaf in ("wi", "wg", "wo")
                elif name in ("['embed']", "['lm_head']"):
                    want = cfg.vocab % tp == 0
                else:
                    want = False
                assert on == want, (shape, arch, name)
