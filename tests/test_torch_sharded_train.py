"""The port's sharding layer and sharded train step against the JAX
package's, at 8 ranks on the CPU.

Rules parity: for all ten configs, `rules_for` and the partition specs of
every parameter, train-state and cache leaf (at a batch the data axes
divide and at one they do not) equal the reference's leaf for leaf, and so
do `batch_axes`, `fix_pspec_for_shape` and `train_batch_shardings`: on the
(pod 2, data 2, model 2) test mesh (the reference's, in a subprocess with 8
forced host devices; the port's, a `DeviceMesh` over 8 gloo ranks) and on
the production geometries (16, 16) and (2, 16, 16) (a geometry stand-in on
both sides; the reference's `NamedSharding` replaced, in its subprocess,
by a holder of the spec, since a real one needs the devices).

Shards: for each case of the step below, each rank's local shard of each
parameter equals the reference's addressable shard on the device at the
same mesh coordinate.  `sharded_init` draws, for every config, the shards
`distribute` cuts from `M.init`'s state, bit for bit.

The sharded step (each weight gathered where it is used, its gradient
reduce-scattered into the rank's shard): `STEP_CASES`, reduced yi-6b and
zamba2, one config of each other family (gemma3-27b and xlstm-350m with
their tied heads, seamless-m4t-medium with its encoder, qwen2-vl-72b),
reduced mixtral-8x7b and grok-1 in both MoE dispatch modes, and yi-6b
over two accumulated microbatches, on SyntheticLM batches of 4 x 64 a
microbatch on (2, 2, 2), two steps from the reference's initial state.  Against the port's unsharded step at the
tolerances of `tests/test_torch_train.py` (the loss at rtol 1e-5,
parameters as its gradient-accumulation test: rtol 2e-4, atol 2e-5).
Against the reference's compiled sharded step (jit with the state and
batch shardings under `activation_sharding`, on a mesh of `AxisType.Auto`
axes: the constraints raise on this jax's default Explicit axes) at
`REF_STEP_TOL`, measured: XLA compiles the step with excess precision and
its own reduction orders (ROADMAP.md, Queue 3); the measurements stand
beside `REF_STEP_TOL`.  For yi-6b and zamba2 also against
`whole_gather_step`, a copy of the step that gathered the whole model
and all-reduced the flat gradient, at the unsharded step's tolerances.
The clipping norm from the shards equals the whole gradient's within
1e-6.

Memory: on `MEMORY_CFG` (8 layers at d_model 512, whose parameters dominate
its activations at 4 x 16), each rank's peak allocation in one step
(`torch.profiler`, `profile_memory=True`, on top of the state it held
before the step; the least of three steps, `step_growth`) stays below `memory_bound`: 16/N bytes a parameter
for its shards of the parameters, m, v and gradient, one layer's
parameters and gradient as its gather makes them (the tensor-parallel
split keeps the `model` half of the attention's, the MLP's, the
embedding's and the head's), the embedding and head gathered with their
gradient, and a margin; and `whole_gather_step`'s peak does not.

A trainer under the mesh saved at step 1 and resumed reaches the straight
run's step-2 state bit for bit; its step-2 checkpoint, written by the 8
ranks, restores on one device to the same state, and a one-device
trainer's checkpoint restores under the mesh to the one-device state.
Rank 0 checks a restore for every rank: a corrupt newest checkpoint is
dropped and every rank resumes from the one before, and a manifest rank 0
fails to read raises on every rank.  A
rank that delivers a batch past the straggler deadline makes every rank
drop that step.

One module-scoped fixture runs the reference subprocess and the 8 port
ranks together, each writing its results to files; the tests read them.
The test process itself never imports jax here: the port's ranks import
this module for `describe_port`.
"""

import dataclasses
import json
import textwrap
from typing import Dict

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch import tree as T
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as S
from repro_torch.parallel import collectives as CC
from repro_torch.parallel.collectives import MeshGeometry
from test_torch_distributed import _run_both  # the reference and 8 ranks, started together

WORLD = 8
TIMEOUT_S = 600
ARCHS = list(C.ARCH_IDS)
STEP_ARCHS = ("yi_6b", "zamba2_1p2b")
MOE_ARCHS = ("mixtral_8x7b", "grok1_314b")
# the other families: gemma3's and xlstm's heads are the tied embedding,
# seamless runs an encoder, qwen2-vl splices pixel embeddings under M-RoPE
FAMILY_ARCHS = ("gemma3_27b", "xlstm_350m", "seamless_m4t_medium", "qwen2_vl_72b")
# the sharded step's cases: name -> (config, MoE dispatch, accumulation steps)
STEP_CASES = {a: (a, "einsum", 1) for a in STEP_ARCHS + FAMILY_ARCHS}
STEP_CASES.update({f"{a}-{d}": (a, d, 1) for a in MOE_ARCHS for d in ("einsum", "index")})
STEP_CASES["yi_6b-accum2"] = ("yi_6b", "einsum", 2)
STEP_BATCH = (4, 64)            # global sequences a microbatch, tokens a sequence
STEPS = 2
CACHE_BATCHES = (4, 1)          # (pod, data) divides 4, not 1
CACHE_LEN = 64
GEOMETRIES = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}
BATCHES = (1, 2, 3, 4, 6, 8, 16, 32, 48, 256)
FIX_CASES = [((("pod", "data"), "model"), (6, 4)), (("data", None), (3, 5)),
             ((("pod", "data", "model"),), (8,)), ((("pod", "data", "model"),), (4,)),
             ((None, ("data", "model")), (2, 6)), (("model",), (32, 3))]
OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=16)
# the reference's compiled sharded step against the port's, as measured on
# the CPU over the two steps of both configs: the loss within 7.7e-8
# (relative), the gradient norm within 3.7e-5 (zamba2's second step; the
# port's sharded against its unsharded step: 2.8e-6), and the updated
# parameters within 0.0375 of the learning rate (zamba2's mamba norm
# scales; yi-6b 0.0044).  AdamW's m / sqrt(v) maps a gradient entry near
# zero to an update of order lr whatever its size, so a rounding-level
# difference in such an entry moves its parameter by a share of lr.  Held
# at rtol 1e-5 (loss), 2e-4 (gradient norm), and 0.1 lr absolute with
# rtol 1e-4 (parameters).
REF_STEP_TOL = {"loss": 1e-5, "grad_norm": 2e-4, "params_rtol": 1e-4, "params_lr": 0.1}
# the straggler case: rank 1 sleeps LATE_S before one batch, past the
# trainer's deadline by a margin no loaded host closes
DEADLINE_S, LATE_S = 1.0, 2.5
# the memory case: reduced yi-6b widened to 8 layers at d_model 512 (18.4M
# parameters, 2.2M a layer), 4 sequences of 16 tokens, one to each batch
# rank (yi-6b shards on `data` and `model`: 4 ways on (2, 2, 2)).  The
# margin: the optimizer's f32 temporaries, a few copies of the leaf it is
# updating (the scaled gradient, m, v, their update and the new parameter:
# `MEMORY_TEMPORARIES` copies of the largest local leaf), and
# `MEMORY_SLACK` for the activations (16 tokens a rank) and the
# collectives' buffers, which gloo's worker threads release a little later
# on some ranks than on others
MEMORY_CFG = dict(n_layers=8, d_model=512, n_heads=8, n_kv_heads=2, head_dim=64, d_ff=1024)
MEMORY_BATCH = (4, 16)
MEMORY_TEMPORARIES = 8
MEMORY_SLACK = 24 << 20
MEMORY_STEPS = 4
# the leaves of MEMORY_CFG that the tensor-parallel split keeps split on
# `model` (name endings), at half their bytes in `memory_bound`
MEMORY_SPLIT = tuple(f"['{g}']['{w}']" for g, ws in (("attn", ("wq", "wk", "wv", "wo")),
                                                     ("mlp", ("wi", "wg", "wo"))) for w in ws
                     ) + ("['embed']", "['lm_head']")


def memory_cfg():
    return dataclasses.replace(C.get_reduced("yi_6b"), **MEMORY_CFG)


def case_cfg(case: str):
    arch, dispatch, _ = STEP_CASES[case]
    return dataclasses.replace(C.get_reduced(arch), moe_dispatch=dispatch)


def step_growth(init, step, batch) -> int:
    """The most bytes one step from `init()`'s state had allocated and not
    yet freed, on top of what was allocated when it began: the profiler's
    allocation events (`profile_memory=True`), recorded from before the
    state is drawn, so that every block a step frees was allocated under
    the profiler.  A step begins at its `loss` range.  The least over the
    steps after the first (`MEMORY_STEPS` in all): gloo's worker thread
    lets go of a collective's buffers only after the rank has gone on, and
    later on a loaded host, which lifts one step's reading now and then."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        state = init()
        for _ in range(MEMORY_STEPS):
            state, _ = step(state, batch)
    events = list(prof.profiler.kineto_results.events())
    begins = sorted(e.start_ns() for e in events if e.name() == "loss")[1:] + [float("inf")]
    growth, now, k, start, peak = [], 0, 0, None, 0
    for e in sorted((e for e in events if e.name() == "[memory]"), key=lambda e: e.start_ns()):
        while e.start_ns() >= begins[k]:      # a step begins before this event
            if start is not None:
                growth.append(peak - start)
            start = peak = now
            k += 1
        now += e.nbytes()
        peak = max(peak, now)
    growth.append(peak - start)
    return min(growth)


def whole_gather_step(cfg, opt, mesh, state_sh, batch_sh):
    """The sharded step as it was before it was memory-sharded: the whole
    model gathered, the flat gradient all-reduced whole (TRINE) and only
    then cut to the rank's shards, the norm taken on the whole gradient.
    Kept here as the memory case's mutant and the per-leaf reduction's
    comparison."""
    from torch.distributed.tensor import DTensor
    from repro_torch.runtime import trainer as TR

    axes = batch_sh["tokens"].spec[0]
    axes = (axes,) if isinstance(axes, str) else axes
    reduce = TR._batch_reduce(mesh, axes)
    param_sh = T.leaves(state_sh.params)

    def to_local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    def step_fn(state, batch):
        local = {k: S.local_shard(mesh, batch_sh[k].spec, v) for k, v in batch.items()}
        share = local["tokens"].numel() / batch["tokens"].numel()
        params = TR.gather(state.params)
        loss, metrics, grads = TR._loss_and_grads(cfg, params, local, None, 1, torch.device("cpu"))
        del params
        shapes = [g.shape for g in grads]
        flat = torch.cat([g.reshape(-1) for g in grads])
        del grads
        if share != 1:
            flat.mul_(share)
        flat = reduce(flat)
        scalars = CC.flat_all_reduce(torch.stack([loss, metrics["ce"], metrics["aux"]]) * share,
                                     mesh, axes)
        grads = [f.view(sh) for f, sh in zip(torch.split(flat, [sh.numel() for sh in shapes]),
                                             shapes)]
        gn = adamw.global_norm(grads)
        mine = [S.local_shard(mesh, sh.spec, g).contiguous() for g, sh in zip(grads, param_sh)]
        new_local = adamw.apply_updates(opt, T.map_structure(to_local, state),
                                        T.unflatten(state.params, mine), grad_norm=gn)
        new_state = T.map_structure(
            lambda t, old: DTensor.from_local(t, old.device_mesh, old.placements, run_check=False,
                                              shape=old.shape, stride=old.stride())
            if isinstance(old, DTensor) else t, new_local, state)
        return new_state, {"ce": scalars[1], "aux": scalars[2], "loss": scalars[0],
                           "grad_norm": gn}
    return step_fn


def memory_bound(got: Dict[str, np.ndarray]) -> int:
    """What a rank may hold in a step of `MEMORY_CFG`: its shards of the
    parameters, m, v and gradient (16/N bytes a parameter), one layer's
    parameters and gradient as gathered (a leaf the tensor-parallel split
    keeps split at half its bytes), the embedding and head gathered with
    their gradient (split by vocabulary: half), and the margin
    (`MEMORY_TEMPORARIES`, `MEMORY_SLACK`)."""
    return int(4 * got["mem_shard_bytes"] + 2 * got["mem_layer_bytes"]
               + 2 * got["mem_top_bytes"] + MEMORY_TEMPORARIES * got["mem_largest_shard_bytes"]
               + MEMORY_SLACK)


def memory_peak(got: Dict[str, np.ndarray], which: str) -> int:
    """The state's shards held before the step (params, m, v) and the
    step's growth over them."""
    return int(3 * got["mem_shard_bytes"] + got[f"mem_growth|{which}"])


def _enc(spec):
    return [a if a is None or isinstance(a, str) else list(a) for a in spec]


def _axes_of(spec) -> set:
    return {a for ax in spec if ax is not None for a in ((ax,) if isinstance(ax, str) else ax)}


def describe_port(mesh) -> dict:
    """Rules and partition specs of the ten configs on `mesh` (a
    `DeviceMesh` or a `MeshGeometry`), as JSON-able values."""
    out = {}
    for arch in ARCHS:
        cfg = C.get(arch)
        rules = S.rules_for(cfg, mesh)
        shapes, specs = M.init_abstract(cfg)
        state = adamw.TrainState(step=torch.empty((), dtype=torch.int32, device="meta"),
                                 params=shapes, m=shapes, v=shapes)
        d = {"rules": {k: v if v is None or isinstance(v, str) else list(v)
                       for k, v in rules.items()},
             "params": {n: _enc(sh.spec) for n, sh in
                        T.leaves_with_path(S.tree_shardings(mesh, specs, rules))},
             "state": {n: _enc(sh.spec) for n, sh in T.leaves_with_path(S.enforce_divisibility(
                 S.tree_shardings(mesh, adamw.state_specs(specs), rules), state))}}
        for b in CACHE_BATCHES:
            cache, cspecs = M.init_cache_abstract(cfg, b, CACHE_LEN)
            sh = S.enforce_divisibility(S.cache_shardings(cfg, mesh, cspecs, b, rules), cache)
            d[f"cache_b{b}"] = {n: _enc(s.spec) for n, s in T.leaves_with_path(sh)}
        out[arch] = d
    out["batch_axes"] = {f"{b}_{st}": S.batch_axes(mesh, b, st) for b in BATCHES
                         for st in ("tp_fsdp", "fsdp_all")}
    out["batch_axes"] = {k: None if v is None else list(v) for k, v in out["batch_axes"].items()}
    names = set(mesh_axis_sizes(mesh))
    out["fix"] = [_enc(S.fix_pspec_for_shape(mesh, S.P(*spec), shape))
                  for spec, shape in FIX_CASES if _axes_of(spec) <= names]
    cfg = C.get("qwen2_vl_72b")
    out["train_batch"] = {}
    for b in (4, 3, 1):
        ex = {"tokens": np.zeros((b, 8)), "positions": np.zeros((3, b, 8)),
              "pixel_embeds": np.zeros((b, 4, 2))}
        out["train_batch"][str(b)] = {k: _enc(v.spec) for k, v in
                                      S.train_batch_shardings(cfg, mesh, ex).items()}
    return out


REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    from types import SimpleNamespace
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro import configs as C
    from repro.models import model as M
    from repro.optim import adamw
    from repro.parallel import actx
    from repro.parallel import sharding as S
    from repro.runtime.trainer import make_train_step

    tmp = sys.argv[1]
    cfgs = json.loads(open(f"{tmp}/setup.json").read())
    inp = dict(np.load(f"{tmp}/inputs.npz"))
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
    keystr = jax.tree_util.keystr

    def enc(spec):
        return [a if a is None or isinstance(a, str) else list(a) for a in spec]

    def specs_of(tree, cls):
        return {keystr(k): enc(v.spec) for k, v in
                jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, cls))}

    abstract = {a: (M.init_abstract(C.get(a)), {b: M.init_cache_abstract(C.get(a), b,
                                                cfgs["cache_len"]) for b in cfgs["cache_batches"]})
                for a in cfgs["archs"]}

    def describe(mesh, cls):
        out = {}
        for arch in cfgs["archs"]:
            cfg = C.get(arch)
            rules = S.rules_for(cfg, mesh)
            (shapes, specs), caches = abstract[arch]
            state = adamw.TrainState(step=jax.ShapeDtypeStruct((), jnp.int32), params=shapes,
                                     m=shapes, v=shapes)
            d = {"rules": {k: v if v is None or isinstance(v, str) else list(v)
                           for k, v in rules.items()},
                 "params": specs_of(S.tree_shardings(mesh, specs, rules), cls),
                 "state": specs_of(S.enforce_divisibility(
                     S.tree_shardings(mesh, adamw.state_specs(specs), rules), state), cls)}
            for b, (cache, cspecs) in caches.items():
                sh = S.enforce_divisibility(S.cache_shardings(cfg, mesh, cspecs, b, rules), cache)
                d[f"cache_b{b}"] = specs_of(sh, cls)
            out[arch] = d
        out["batch_axes"] = {f"{b}_{st}": S.batch_axes(mesh, b, st) for b in cfgs["batches"]
                             for st in ("tp_fsdp", "fsdp_all")}
        out["batch_axes"] = {k: None if v is None else list(v)
                             for k, v in out["batch_axes"].items()}
        names = set(mesh.axis_names)
        out["fix"] = [enc(S.fix_pspec_for_shape(mesh, P(*[a if a is None or isinstance(a, str)
                                                          else tuple(a) for a in spec]), shape))
                      for spec, shape in cfgs["fix_cases"]
                      if {x for a in spec if a is not None
                          for x in ((a,) if isinstance(a, str) else a)} <= names]
        cfg = C.get("qwen2_vl_72b")
        out["train_batch"] = {}
        for b in (4, 3, 1):
            ex = {"tokens": np.zeros((b, 8)), "positions": np.zeros((3, b, 8)),
                  "pixel_embeds": np.zeros((b, 4, 2))}
            out["train_batch"][str(b)] = {k: enc(v.spec) for k, v in
                                          S.train_batch_shardings(cfg, mesh, ex).items()}
        return out

    # the reduced configs' initial weights, first (the port's ranks wait
    # for them), then their addressable shards by mesh coordinate
    inits = {a: M.init(C.get_reduced(a), jax.random.PRNGKey(0))
             for a in {arch for arch, _, _ in cfgs["cases"].values()}}
    np.savez(f"{tmp}/init.tmp.npz", **{f"{a}|{keystr(k)}": np.asarray(v)
                                        for a, (p, _) in inits.items()
                                        for k, v in jax.tree_util.tree_leaves_with_path(p)})
    os.replace(f"{tmp}/init.tmp.npz", f"{tmp}/ref_init.npz")
    arrays = {}
    coords = {d: tuple(int(i) for i in c) for c, d in np.ndenumerate(mesh.devices)}
    for case, (arch, dispatch, accum) in cfgs["cases"].items():
        cfg = dataclasses.replace(C.get_reduced(arch), moe_dispatch=dispatch)
        params, pspecs = inits[arch]
        rules = S.rules_for(cfg, mesh)
        sh = S.enforce_divisibility(S.tree_shardings(mesh, pspecs, rules), params)
        placed = jax.device_put(params, sh)
        for k, v in jax.tree_util.tree_leaves_with_path(placed):
            for s in v.addressable_shards:
                arrays[f"shard|{case}|{keystr(k)}|{coords[s.device]}"] = np.asarray(s.data)

        # the compiled sharded step, two steps
        opt = adamw.OptConfig(**cfgs["opt"])
        state = adamw.init_state(opt, params)
        state_sh = S.enforce_divisibility(
            S.tree_shardings(mesh, adamw.state_specs(pspecs), rules),
            jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state))
        batch = {k[len(case) + 7:]: jnp.asarray(v) for k, v in inp.items()
                 if k.startswith(f"batch|{case}|")}
        batch_sh = S.train_batch_shardings(cfg, mesh, batch)
        with mesh, actx.activation_sharding(mesh, S.batch_axes(mesh, 4)):
            step = jax.jit(make_train_step(cfg, opt, accum_steps=accum),
                           in_shardings=(state_sh, batch_sh))
            for i in range(cfgs["steps"]):
                # the compiled step may lay its outputs out otherwise
                state, m = step(jax.device_put(state, state_sh), jax.device_put(batch, batch_sh))
                for name, val in m.items():
                    arrays[f"step|{case}|{i}|{name}"] = np.asarray(val)
        for k, v in jax.tree_util.tree_leaves_with_path(state.params):
            arrays[f"stepped|{case}|{keystr(k)}"] = np.asarray(v)
    np.savez(f"{tmp}/ref.npz", **arrays)
    rules_out = {"test": describe(mesh, NamedSharding)}

    # the production geometries: a stand-in mesh and a spec holder
    class Holder:
        def __init__(self, mesh, spec):
            self.mesh, self.spec = mesh, spec

    S.NamedSharding = Holder
    for name, (shape, names) in cfgs["geometries"].items():
        g = SimpleNamespace(axis_names=tuple(names), devices=SimpleNamespace(shape=tuple(shape)))
        rules_out[name] = describe(g, Holder)
    open(f"{tmp}/ref_rules.json", "w").write(json.dumps(rules_out))
""")

RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, shutil, sys, time
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, tmp, tests = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    sys.path.insert(0, tests)
    from test_torch_sharded_train import (ARCHS, DEADLINE_S, LATE_S, MEMORY_BATCH, MEMORY_SPLIT,
                                          OPT_KW,
                                          STEP_ARCHS, STEP_CASES, STEPS, case_cfg, describe_port,
                                          memory_cfg, whole_gather_step, step_growth)
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as C
    from repro_torch import tree as T
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import wire as W
    from repro_torch.runtime import trainer as TR

    mesh = make_test_mesh(data=2, model=2, pod=2, device_type="cpu")
    if rank == 0:
        open(f"{tmp}/port_rules.json", "w").write(json.dumps(describe_port(mesh)))
    deadline = time.time() + 540
    while not os.path.exists(f"{tmp}/ref_init.npz"):      # the reference's weights
        assert time.time() < deadline, "the reference wrote no initial weights"
        time.sleep(0.2)
    ref = np.load(f"{tmp}/ref_init.npz")
    inp = np.load(f"{tmp}/inputs.npz")
    opt = adamw.OptConfig(**OPT_KW)
    out = {"coord": np.array(mesh.get_coordinate())}

    def ref_params(arch, cfg):
        like, _ = M.init_abstract(cfg)
        return T.unflatten(like, [torch.from_numpy(ref[f"{arch}|{n}"])
                                  for n, _ in T.leaves_with_path(like)])

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    for case, (arch, _, accum) in STEP_CASES.items():
        cfg = case_cfg(case)
        params = ref_params(arch, cfg)
        sh = S.enforce_divisibility(
            S.tree_shardings(mesh, M.param_specs(cfg), S.rules_for(cfg, mesh)), params)
        for n, t in T.leaves_with_path(TR.distribute(mesh, params, sh)):
            out[f"shard|{case}|{n}"] = local(t)

        batch = {k[len(case) + 7:]: torch.from_numpy(v) for k, v in inp.items()
                 if k.startswith(f"batch|{case}|")}
        step, state_sh, batch_sh = TR.build_sharded_step(cfg, opt, mesh, M.param_specs(cfg),
                                                         batch, device="cpu", accum_steps=accum)
        state = TR.distribute(mesh, adamw.init_state(opt, params), state_sh)
        plain = TR.make_train_step(cfg, opt, device="cpu", accum_steps=accum)
        pstate = adamw.init_state(opt, params)
        old = (whole_gather_step(cfg, opt, mesh, state_sh, batch_sh) if case in STEP_ARCHS
               else None)
        ostate = TR.distribute(mesh, adamw.init_state(opt, params), state_sh)
        for i in range(STEPS):
            state, m = step(state, batch)
            pstate, pm = plain(pstate, batch)
            for name in m:
                out[f"step|{case}|{i}|{name}"] = m[name]
                out[f"plain|{case}|{i}|{name}"] = pm[name]
            if old is not None:
                ostate, om = old(ostate, batch)
                for name in om:
                    out[f"whole|{case}|{i}|{name}"] = om[name]
        for n, t in T.leaves_with_path(TR.gather(state.params)):
            out[f"stepped|{case}|{n}"] = t
        for n, t in T.leaves_with_path(pstate.params):
            out[f"plain_stepped|{case}|{n}"] = t
        if old is not None:
            for n, t in T.leaves_with_path(TR.gather(ostate.params)):
                out[f"whole_stepped|{case}|{n}"] = t
        # the clipping norm from the shards, on the stepped parameters
        shards = [local(t) for t in T.leaves(state.params)]
        out[f"norm_shards|{case}"] = TR.shard_global_norm(mesh, shards, T.leaves(state_sh.params))
        out[f"norm_whole|{case}"] = adamw.global_norm(TR.gather(state.params))

    # a fresh state drawn shard by shard against M.init's, cut
    for arch in ARCHS:
        cfg = C.get_reduced(arch)
        sh = TR.state_shardings(cfg, mesh)
        drawn = TR.sharded_init(mesh, opt, cfg, sh, seed=0, device="cpu")
        cut = TR.distribute(mesh, adamw.init_state(opt, M.init(cfg, seed=0, device="cpu",
                                                                expert_dtype=torch.float32)), sh)
        out[f"init_differing|{arch}"] = np.array(
            [n for (n, a), b in zip(T.leaves_with_path(drawn), T.leaves(cut))
             if type(a) is not type(b) or not torch.equal(local(a), local(b))] or ["none"])

    # memory: one step's peak allocation, the new step's and whole_gather_step's
    mcfg = memory_cfg()
    mdata = DataConfig(global_batch=MEMORY_BATCH[0], seq_len=MEMORY_BATCH[1])
    mbatch = {k: torch.as_tensor(v) for k, v in SyntheticLM(mcfg, mdata).batch_at(0).items()}
    mstep, msh, mbsh = TR.build_sharded_step(mcfg, opt, mesh, M.param_specs(mcfg), mbatch,
                                             device="cpu")
    shapes, _ = M.init_abstract(mcfg)
    out["mem_params"] = np.array(sum(t.numel() for t in T.leaves(shapes)))
    out["mem_full_state_bytes"] = np.array(16 * int(out["mem_params"]))
    # what a rank gathers: a leaf the tensor-parallel split keeps split
    # on `model` (2 ways here) at half its bytes.  Which leaves split is
    # MEMORY_CFG's own: 8 heads and 2 KV heads, a d_ff of 1024 and a
    # vocabulary of 512 all divide by 2
    held = {n: 4 * t.numel() // (2 if n.endswith(MEMORY_SPLIT) else 1)
            for n, t in T.leaves_with_path(shapes)}
    out["mem_split"] = np.array(sorted(n for (n, _), keep in zip(
        T.leaves_with_path(shapes), TR.tp_split_leaves(mcfg, mesh, mbsh["tokens"].spec[0],
                                                       T.leaves(msh.params))) if keep))
    out["mem_layer_bytes"] = np.array(sum(held[n] // t.shape[0] for n, t in
                                          T.leaves_with_path(shapes) if n.startswith("['stages']")))
    out["mem_top_bytes"] = np.array(held["['embed']"] + held["['lm_head']"])
    def minit():
        return TR.sharded_init(mesh, opt, mcfg, msh, seed=0, device="cpu")

    for name, fn in (("new", mstep), ("whole", whole_gather_step(mcfg, opt, mesh, msh, mbsh))):
        out[f"mem_growth|{name}"] = np.array(step_growth(minit, fn, mbatch))
    shard_bytes = [4 * local(t).numel() for t in T.leaves(minit().params)]
    out["mem_shard_bytes"] = np.array(sum(shard_bytes))
    out["mem_largest_shard_bytes"] = np.array(max(shard_bytes))

    # a trainer under the mesh: saved every step, resumed from step 1
    cfg = C.get_reduced("yi_6b")
    data = DataConfig(global_batch=4, seq_len=64)
    ck = f"{tmp}/ckpt"
    tc = TR.TrainerConfig(ckpt_dir=ck, ckpt_every=1, log_every=1000)
    straight = TR.Trainer(cfg, opt, data, tc, mesh=mesh, resume=False, device="cpu")
    straight.run(2, quiet=True)
    want = straight.full_state()
    # its step-2 checkpoint, written by the 8 ranks, read on one device
    one = store.restore(ck, 2, T.map_structure(torch.zeros_like, want))
    out["mesh_to_one_differing"] = np.array([n for (n, a), b in zip(T.leaves_with_path(one),
                                             T.leaves(want)) if not torch.equal(a, b)] or ["none"])
    dist.barrier()
    if rank == 0:
        shutil.rmtree(f"{ck}/step_00000002")
    dist.barrier()
    resumed = TR.Trainer(cfg, opt, data, tc, mesh=mesh, resume=True, device="cpu")
    out["resumed_from"] = np.array(resumed.start_step)
    resumed.run(2, quiet=True)
    got = resumed.full_state()
    out["resume_differing"] = np.array([n for (n, a), b in zip(T.leaves_with_path(got),
                                        T.leaves(want)) if not torch.equal(a, b)] or ["none"])
    out["trainer_losses"] = np.array([h["loss"] for h in straight.history])
    single = TR.Trainer(cfg, opt, data, dataclasses.replace(tc, ckpt_dir=f"{tmp}/single_{rank}"),
                        resume=False, device="cpu")
    single.run(2, quiet=True)
    out["trainer_losses_single"] = np.array([h["loss"] for h in single.history])
    # rank 0's one-device checkpoint (step 2) restored under the mesh
    dist.barrier()
    from_one = TR.Trainer(cfg, opt, data, dataclasses.replace(tc, ckpt_dir=f"{tmp}/single_0"),
                          mesh=mesh, resume=True, device="cpu")
    out["one_to_mesh_from"] = np.array(from_one.start_step)
    out["one_to_mesh_differing"] = np.array(
        [n for (n, a), b in zip(T.leaves_with_path(from_one.full_state()), T.leaves(single.state))
         if not torch.equal(a, b)] or ["none"])

    # rank 0 checks a restore for every rank: a corrupt newest checkpoint is
    # dropped and every rank resumes from the one before; a manifest rank 0
    # fails to read makes every rank raise, none left waiting for it
    dist.barrier()
    if rank == 0:
        with open(f"{ck}/step_00000002/leaf_00000.npy", "r+b") as f:
            f.write(b"corrupted!")
    dist.barrier()
    walked = TR.Trainer(cfg, opt, data, tc, mesh=mesh, resume=True, device="cpu")
    out["walked_back_to"] = np.array(walked.start_step)
    out["corrupt_left"] = np.array(os.path.exists(f"{ck}/step_00000002"))
    dist.barrier()
    if rank == 0:
        manifest = json.loads(open(f"{ck}/step_00000001/manifest.json").read())
        del next(iter(manifest["leaves"].values()))["file"]
        open(f"{ck}/step_00000001/manifest.json", "w").write(json.dumps(manifest))
    dist.barrier()
    try:
        TR.Trainer(cfg, opt, data, tc, mesh=mesh, resume=True, device="cpu")
        out["unreadable_manifest"] = np.array("no error")
    except Exception as e:
        out["unreadable_manifest"] = np.array(type(e).__name__)

    # a straggler: rank 1 delivers step 2's batch past the deadline; every
    # rank drops that step, and none waits in a collective its peers skip
    class Late:
        def __init__(self, source):
            self.source = source

        def batch_at(self, step):
            if rank == 1 and step == 1:
                time.sleep(LATE_S)
            return self.source.batch_at(step)

    late = TR.Trainer(cfg, opt, data, dataclasses.replace(tc, ckpt_dir=f"{tmp}/late",
                                                           straggler_deadline_s=DEADLINE_S),
                      resume=False, device="cpu", mesh=mesh,
                      source=Late(SyntheticLM(cfg, data)))
    stats = late.run(3, quiet=True)["straggler"]
    out["late_steps"] = np.array([h["step"] for h in late.history])
    out["late_losses"] = np.array([h["loss"] for h in late.history])
    out["late_stats"] = np.array([stats["steps"], stats["dropped"]])

    # what stays refused under a mesh
    def refusal(fn):
        try:
            fn()
            return np.array("no error")
        except (NotImplementedError, ValueError) as e:
            return np.array(f"{type(e).__name__}: {e}")

    wired = dataclasses.replace(cfg, wire_bits=8)
    out["refused_wire"] = refusal(lambda: W.make_param_wire(wired, mesh))
    out["refused_launch"] = refusal(lambda: train.main(
        ["--arch", "yi_6b", "--reduced", "--device", "cpu", "--steps", "1",
         "--ckpt", f"{tmp}/launch", "--mesh", "single"]))
    np.savez(f"{tmp}/port_{rank}.npz",
             **{k: v.detach().numpy() if torch.is_tensor(v) else v for k, v in out.items()})
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_sharded_train")
    inputs = {}
    for case, (_, _, accum) in STEP_CASES.items():
        data = DataConfig(global_batch=STEP_BATCH[0] * accum, seq_len=STEP_BATCH[1])
        for k, v in SyntheticLM(case_cfg(case), data).batch_at(0).items():
            inputs[f"batch|{case}|{k}"] = v
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "setup.json").write_text(json.dumps({
        "archs": ARCHS, "cases": STEP_CASES, "steps": STEPS, "opt": OPT_KW,
        "cache_batches": list(CACHE_BATCHES), "cache_len": CACHE_LEN, "batches": list(BATCHES),
        "fix_cases": [[_enc(spec), list(shape)] for spec, shape in FIX_CASES],
        "geometries": {k: [list(shape), list(names)] for k, (shape, names) in GEOMETRIES.items()},
    }))
    _run_both(tmp, REF_SCRIPT, RANK_SCRIPT, TIMEOUT_S)
    ref_rules = json.loads((tmp / "ref_rules.json").read_text())
    port_rules = {"test": json.loads((tmp / "port_rules.json").read_text())}
    for name, (shape, names) in GEOMETRIES.items():
        port_rules[name] = json.loads(json.dumps(describe_port(MeshGeometry(shape, names))))
    return {"ref_rules": ref_rules, "port_rules": port_rules,
            "ref": dict(np.load(tmp / "ref.npz")),
            "ranks": [dict(np.load(tmp / f"port_{r}.npz")) for r in range(WORLD)]}


MESHES = ["test"] + list(GEOMETRIES)
PARTS = ["rules", "params", "state"] + [f"cache_b{b}" for b in CACHE_BATCHES]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_specs_match_reference(runs, mesh, arch):
    """`rules_for`, every parameter's spec, every train-state leaf's after
    `enforce_divisibility`, and every cache leaf's at batch 4 and 1."""
    ref, port = runs["ref_rules"][mesh][arch], runs["port_rules"][mesh][arch]
    for part in PARTS:
        assert port[part] == ref[part], (mesh, arch, part)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("what", ["batch_axes", "fix", "train_batch"])
def test_batch_rules_match_reference(runs, mesh, what):
    assert runs["port_rules"][mesh][what] == runs["ref_rules"][mesh][what]


@pytest.mark.parametrize("arch", STEP_CASES)
def test_local_shards_match_the_references_addressable_shards(runs, arch):
    """Each rank's shard of each reduced parameter against the reference's
    shard on the device at the rank's mesh coordinate, exactly."""
    ref, n = runs["ref"], 0
    for got in runs["ranks"]:
        coord = tuple(int(c) for c in got["coord"])
        for key, local in got.items():
            if key.startswith(f"shard|{arch}|"):
                np.testing.assert_array_equal(local, ref[f"{key}|{coord}"], err_msg=key)
                n += 1
    assert n == len([k for k in ref if k.startswith(f"shard|{arch}|")])


def _metric(got, kind, arch, i, name):
    return float(got[f"{kind}|{arch}|{i}|{name}"])


@pytest.mark.parametrize("arch", STEP_CASES)
def test_sharded_step_matches_the_unsharded_step(runs, arch):
    """Two steps of 4 x 64 on (2, 2, 2) against the port's one-device step
    from the same state: loss, its parts and the gradient norm on every
    rank, and the updated parameters."""
    for got in runs["ranks"]:
        for i in range(STEPS):
            for name in ("loss", "ce", "grad_norm"):
                np.testing.assert_allclose(_metric(got, "step", arch, i, name),
                                           _metric(got, "plain", arch, i, name),
                                           rtol=1e-5 if name != "grad_norm" else 1e-4,
                                           err_msg=f"{arch} step {i} {name}")
    got = runs["ranks"][0]
    for key in [k for k in got if k.startswith(f"stepped|{arch}|")]:
        np.testing.assert_allclose(got[key], got["plain_" + key], rtol=2e-4, atol=2e-5,
                                   err_msg=key)


@pytest.mark.parametrize("arch", STEP_CASES)
def test_sharded_step_matches_the_references_compiled_step(runs, arch):
    """The same two steps against the reference's jitted sharded step, at
    `REF_STEP_TOL`."""
    ref, got = runs["ref"], runs["ranks"][0]
    for i in range(STEPS):
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(_metric(got, "step", arch, i, name),
                                       float(ref[f"step|{arch}|{i}|{name}"]),
                                       rtol=REF_STEP_TOL[name], err_msg=f"{arch} {i} {name}")
    atol = REF_STEP_TOL["params_lr"] * OPT_KW["lr"]
    for key in [k for k in got if k.startswith(f"stepped|{arch}|")]:
        np.testing.assert_allclose(got[key], ref[key], rtol=REF_STEP_TOL["params_rtol"],
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_per_leaf_reduction_matches_the_flat_one(runs, arch):
    """The new step against `whole_gather_step` (the whole gradient all-reduced
    flat) over the same two steps, at the unsharded step's tolerances."""
    got = runs["ranks"][0]
    for i in range(STEPS):
        for name in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(_metric(got, "step", arch, i, name),
                                       _metric(got, "whole", arch, i, name),
                                       rtol=1e-5 if name != "grad_norm" else 1e-4,
                                       err_msg=f"{arch} step {i} {name}")
    for key in [k for k in got if k.startswith(f"stepped|{arch}|")]:
        np.testing.assert_allclose(got[key], got["whole_" + key], rtol=2e-4, atol=2e-5,
                                   err_msg=key)


@pytest.mark.parametrize("arch", STEP_CASES)
def test_clipping_norm_from_shards_matches_the_whole(runs, arch):
    for got in runs["ranks"]:
        np.testing.assert_allclose(float(got[f"norm_shards|{arch}"]),
                                   float(got[f"norm_whole|{arch}"]), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_init_draws_init_s_shards(runs, arch):
    """`sharded_init`'s state, drawn shard by shard, against `M.init`'s cut
    by `distribute`: every leaf's local tensor equal, on every rank."""
    for got in runs["ranks"]:
        assert list(got[f"init_differing|{arch}"]) == ["none"]


def test_sharded_step_memory_stays_below_the_bound(runs):
    """The state a rank held before the step plus the step's peak
    allocation (`memory_peak`), below `memory_bound` and below half of
    the full state's bytes, on every rank; the leaves the step keeps split
    are the ones the bound counts at half (`MEMORY_SPLIT`)."""
    for got in runs["ranks"]:
        assert all(n.endswith(MEMORY_SPLIT) for n in got["mem_split"])
        assert len(got["mem_split"]) == len(MEMORY_SPLIT)
        peak = memory_peak(got, "new")
        assert peak <= memory_bound(got), (peak, memory_bound(got))
        assert peak < int(got["mem_full_state_bytes"]) // 2, peak


def test_whole_gather_step_breaks_the_memory_bound(runs):
    """The mutant: the step that gathers the whole model and reduces the
    whole gradient exceeds `memory_bound` on every rank."""
    for got in runs["ranks"]:
        peak = memory_peak(got, "whole")
        assert peak > memory_bound(got), (peak, memory_bound(got))


def test_every_rank_reports_the_same_metrics(runs):
    for got in runs["ranks"][1:]:
        for key in runs["ranks"][0]:
            if key.startswith("step|"):
                assert float(got[key]) == float(runs["ranks"][0][key]), key


def test_trainer_under_the_mesh_resumes_bitwise(runs):
    for got in runs["ranks"]:
        assert int(got["resumed_from"]) == 1
        assert list(got["resume_differing"]) == ["none"]


def test_mesh_checkpoint_restores_on_one_device(runs):
    for got in runs["ranks"]:
        assert list(got["mesh_to_one_differing"]) == ["none"]


def test_one_device_checkpoint_restores_under_the_mesh(runs):
    for got in runs["ranks"]:
        assert int(got["one_to_mesh_from"]) == 2
        assert list(got["one_to_mesh_differing"]) == ["none"]


def test_a_mesh_restore_walks_back_and_fails_together(runs):
    """Rank 0 checks the checkpoints for every rank: a corrupt newest one is
    dropped and every rank resumes from the one before; a manifest rank 0
    fails to read (a leaf's entry without its file) raises on every rank,
    rank 0's own error there, and no rank waits for it."""
    for rank, got in enumerate(runs["ranks"]):
        assert int(got["walked_back_to"]) == 1
        assert not bool(got["corrupt_left"])
        assert str(got["unreadable_manifest"]) == ("KeyError" if rank == 0 else "RuntimeError")


def test_trainer_under_the_mesh_matches_the_one_device_trainer(runs):
    for got in runs["ranks"]:
        np.testing.assert_allclose(got["trainer_losses"], got["trainer_losses_single"], rtol=1e-5)


def test_a_late_rank_drops_the_step_on_every_rank(runs):
    """Rank 1 misses the deadline on step 2 alone: every rank drops step 2
    and trains steps 1 and 3 with the same losses (a rank deciding alone
    would leave its peers' collectives unmatched)."""
    first = runs["ranks"][0]
    assert 2 not in list(first["late_steps"]) and 1 <= int(first["late_stats"][1])
    assert int(first["late_stats"][0]) == 3
    for got in runs["ranks"]:
        for key in ("late_steps", "late_losses", "late_stats"):
            np.testing.assert_array_equal(got[key], first[key], err_msg=key)


@pytest.mark.parametrize("what, want", [
    ("refused_wire", "ValueError: the wire over a mesh needs the sharding rules"),
    ("refused_launch", "ValueError: a {'data': 16, 'model': 16} mesh needs 256 ranks; "
                       "the process group has 8"),
])
def test_what_stays_refused_under_a_mesh(runs, what, want):
    for got in runs["ranks"]:
        assert str(got[what]).startswith(want), str(got[what])


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_init_and_their_specs(arch):
    """`init_abstract` and `init_cache_abstract` hold meta tensors of the
    shapes `init` and `init_cache` give, and their spec trees have one
    entry per dimension of each leaf."""
    cfg = C.get_reduced(arch)
    shapes, specs = M.init_abstract(cfg)
    params = M.init(cfg, device="cpu", expert_dtype=torch.float32)
    spec_leaves = dict(T.leaves_with_path(S.tree_shardings(None, specs, {})))
    for (n, a), b in zip(T.leaves_with_path(shapes), T.leaves(params)):
        assert a.device.type == "meta" and a.shape == b.shape and a.dtype == b.dtype, n
        assert len(spec_leaves[n].spec) == a.ndim, n
    cache, cspecs = M.init_cache_abstract(cfg, 3, 16)
    cspec_leaves = dict(T.leaves_with_path(S.tree_shardings(None, cspecs, {})))
    for (n, a), b in zip(T.leaves_with_path(cache), T.leaves(M.init_cache(cfg, 3, 16, "cpu"))):
        assert a.device.type == "meta" and a.shape == b.shape and a.dtype == b.dtype, n
        assert len(cspec_leaves[n].spec) == a.ndim, n


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert S.placements(_Mesh, S.P(("pod", "data"), "model"), 2) == [Shard(0), Shard(0), Shard(1)]
    assert S.placements(_Mesh, S.P(None, "data"), 3) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="not in the mesh's order"):
        S.placements(_Mesh, S.P(("data", "pod")), 1)
