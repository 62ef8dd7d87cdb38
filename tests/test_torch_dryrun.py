"""The dry-run (`launch/dryrun.py`) over a fake process group, its counts
(`launch/hlo_analysis.count_step`), `configs.input_specs`, and the
co-design chunk program (`core/accelerator.CodesignChunk`), on the CPU.

One module fixture starts, at once, each in its own process:

  * the reference (`REF_SCRIPT`, 512 forced host devices, no compile): for
    every (arch, shape, mesh) cell of the 10 x 4 x 2 grid, the bytes of a
    device's shards of the arguments its dry-run lowers the step with
    (`NamedSharding.shard_shape` of `tree_shardings` / `cache_shardings` /
    `train_batch_shardings`, as `_lower_cell` lays them out), and its
    `input_specs`' shapes and dtypes;
  * `FAKE_SCRIPT`: reduced yi-6b's train step (4 x 64 tokens) as rank 0 of
    a fake process group on (pod 2, data 2, model 2): `dryrun.measure`'s
    counter and `count_step`'s `HloStats`;
    and, with the kernels on (`KERNEL_CELLS`: a 128-aligned photonic yi-6b
    and reduced zamba2, prefill 4 x 128), `measure`'s counts beside
    `FlopCounterMode`'s count by operator of the same fake step, and the
    aligned yi-6b again with its plain versions;
  * the same step at 8 real gloo ranks (`RANK_SCRIPT`): the bytes it hands
    to c10d by kind (the collectives' tensor entry points wrapped),
    `FlopCounterMode`'s count of rank 0's step, and the most bytes rank 0
    allocated in it beyond what it held when it began (`torch.profiler`'s
    allocation events);
  * `python -m repro_torch.launch.dryrun` on yi-6b decode_32k single at
    full size, and on reduced yi-6b prefill_32k on both meshes, with and
    without `--tag`.

Checked: the fake rank's collective payload bytes and counts by kind equal
the real rank's, its `dot_flops` the flop counter's, and its temporary
bytes the real rank's allocation peak within `TEMP_FACTOR`; with the
kernels on, every kernel counted by its custom operator, and the aligned
cell's count the plain versions' less the masked-out attention pairs; for all 80 cells
the dry-run's argument bytes a device (`dryrun.argument_bytes`, which
`measure` asserts its fake arguments hold) equal the reference's, and
`input_specs` the reference's; the full-size record has every field the
reference's record has; `benchmarks/torch_roofline.py` reads the port's
records (`n_ok` 2: the tagged variants left out).  In this process: each
kernel's custom operator under `FakeTensorMode` counted as its plain
version (`KERNEL_OPS`), and the chunk program against the eager chunk
evaluation, bit for bit, with a padded last chunk.

The test process imports no jax; the reference runs in its subprocess.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch import tree as T
from repro_torch.launch import dryrun as D

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
TIMEOUT_S = 600
CELLS = [(a, s, m) for a in C.ARCH_IDS for s in C.SHAPES for m in ("single", "multi")]
# the reduced train cell counted on the fake mesh and run at 8 gloo ranks
COUNT_ARCH, COUNT_BATCH, COUNT_SEQ = "yi_6b", 4, 64
# the reference's record (`src/repro/launch/dryrun.py`, `run_cell`)
REF_RECORD_FIELDS = {"arch", "shape", "mesh", "strategy", "remat", "opt_dtype", "wire_bits",
                     "status", "skip_reason", "n_devices", "lower_s", "compile_s", "memory",
                     "cost_flops", "cost_bytes", "hlo_stats", "roofline"}
REF_MEMORY_FIELDS = {"temp_size_in_bytes", "argument_size_in_bytes", "output_size_in_bytes",
                     "alias_size_in_bytes", "generated_code_size_in_bytes"}
# the most the real rank 0's allocation peak in the step may exceed the
# fake rank's temporary bytes by (a factor): beyond the storages the step
# dispatches, which the two count alike, it holds gloo's own buffers, which
# its worker thread lets go of late on a loaded host (1.11x and 1.36x read
# here alone)
TEMP_FACTOR = 2.0
# (name, config changes) of the reduced cells run with the kernels on, at
# prefill 4 x 128 on the fake (2, 2, 2) mesh; the first is run again with
# the plain versions (every linear of it takes the tiled photonic path)
ALIGNED = dict(d_model=128, n_heads=4, n_kv_heads=1, head_dim=32, d_ff=256, vocab=512,
               use_photonic_mac=True)
KERNEL_CELLS = (("yi_6b", ALIGNED), ("zamba2_1p2b", {}))
KERNEL_SEQ, KERNEL_BATCH = 128, 4

REF_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax, jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from repro import configs as C
    from repro.models import model as M
    from repro.optim import adamw
    from repro.parallel import sharding as S

    tmp = sys.argv[1]
    devs = jax.devices()
    meshes = {"single": jax.make_mesh((16, 16), ("data", "model"), devices=devs[:256]),
              "multi": jax.make_mesh((2, 16, 16), ("pod", "data", "model"), devices=devs)}
    keystr = jax.tree_util.keystr

    def nbytes(tree, shardings):
        return int(sum(np.prod(sh.shard_shape(tuple(x.shape))) * np.dtype(x.dtype).itemsize
                       for x, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(shardings))))

    out = {}
    for arch in C.ARCH_IDS:
        cfg = C.get(arch)
        params_shape, param_specs = M.init_abstract(cfg)
        for mesh_kind, mesh in meshes.items():
            rules = S.rules_for(cfg, mesh)
            param_sh = S.enforce_divisibility(S.tree_shardings(mesh, param_specs, rules),
                                              params_shape)
            for shape_name, shape in C.SHAPES.items():
                specs = C.input_specs(cfg, shape)
                key = f"{arch}|{shape_name}|{mesh_kind}"
                out[f"specs|{key}"] = {keystr(k): [list(v.shape), str(v.dtype)]
                                       for k, v in jax.tree_util.tree_leaves_with_path(specs)}
                if shape.kind == "train":
                    opt = adamw.OptConfig(state_dtype=(
                        "bfloat16" if "pod" in cfg.fsdp_axes else "float32"))
                    state_shape = jax.eval_shape(lambda p: adamw.init_state(opt, p),
                                                 params_shape)
                    state_sh = S.enforce_divisibility(
                        S.tree_shardings(mesh, adamw.state_specs(param_specs), rules),
                        state_shape)
                    batch_sh = S.train_batch_shardings(cfg, mesh, specs["batch"])
                    n = nbytes(state_shape, state_sh) + nbytes(specs["batch"], batch_sh)
                elif shape.kind == "prefill":
                    batch_sh = S.train_batch_shardings(cfg, mesh, specs["batch"])
                    n = nbytes(params_shape, param_sh) + nbytes(specs["batch"], batch_sh)
                else:
                    cache_shape, cache_specs = M.init_cache_abstract(cfg, shape.global_batch,
                                                                     shape.seq_len)
                    cache_sh = S.enforce_divisibility(
                        S.cache_shardings(cfg, mesh, cache_specs, shape.global_batch, rules),
                        cache_shape)
                    tok_sh = S.train_batch_shardings(cfg, mesh, {"t": specs["tokens"]})["t"]
                    ps = NamedSharding(mesh, PartitionSpec())
                    n = (nbytes(params_shape, param_sh) + nbytes(specs["cache"], cache_sh)
                         + nbytes(specs["tokens"], tok_sh) + nbytes(specs["pos"], ps))
                    if cfg.encoder_layers:
                        enc_sh = S.train_batch_shardings(cfg, mesh, {"e": specs["enc_out"]})["e"]
                        n += nbytes(specs["enc_out"], enc_sh)
                out[f"bytes|{key}"] = n
    open(f"{tmp}/ref.json", "w").write(json.dumps(out))
""")

COMMON = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from repro_torch import configs as C
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.runtime import trainer as TR

    cfg = C.get_reduced("{arch}")
    shape = C.ShapeSpec("train_small", {seq}, {batch}, "train")
""")

FAKE_SCRIPT = COMMON + textwrap.dedent("""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.parallel.collectives import prepare_axis_groups

    tmp = sys.argv[1]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = make_test_mesh(data=2, model=2, pod=2, device_type="cpu")
    prepare_axis_groups(mesh)
    counter, memory, _ = D.measure(cfg, shape, mesh)
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = D._lower_cell(cfg, shape, mesh)
        stats = H.count_step(step, 8, max_trip=2, known=args)
    payload, counts = {}, {}
    for e in counter.events:
        payload[e.kind] = payload.get(e.kind, 0) + e.operand_bytes
        counts[e.kind] = counts.get(e.kind, 0) + 1

    from torch.utils.flop_counter import FlopCounterMode
    pshape = C.ShapeSpec("prefill_small", {kseq}, {kbatch}, "prefill")
    kernel_cells = []
    for i, (arch, changes) in enumerate({kcells}):
        for kernels in ((True, False) if i == 0 else (True,)):
            kcfg = dataclasses.replace(C.get_reduced(arch), **changes, use_kernels=kernels)
            kcounter, kmemory, _ = D.measure(kcfg, pshape, mesh)
            with FakeTensorMode(allow_non_fake_inputs=True):
                kstep, _ = D._lower_cell(kcfg, pshape, mesh)
                with FlopCounterMode(display=False) as fc:
                    kstep()
            kernel_cells.append({
                "arch": arch, "kernels": kernels, "dot_flops": kcounter.dot_flops,
                "flop_counter": fc.get_total_flops(), "memory": kmemory,
                "by_op": {str(k): v for k, v in fc.get_flop_counts()["Global"].items()},
                "n_layers": kcfg.n_layers, "heads": kcfg.n_heads, "head_dim": kcfg.head_dim_})
    open(f"{tmp}/fake.json", "w").write(json.dumps({
        "payload": payload, "counts": counts, "dot_flops": counter.dot_flops,
        "memory": memory, "stats": stats.to_json(), "kernel_cells": kernel_cells,
        "groups": sorted({e.group_size for e in counter.events})}))
""")

RANK_SCRIPT = COMMON + textwrap.dedent("""
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import tree as T
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.parallel import actx as AX
    from repro_torch.parallel import collectives as CC

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    mesh = make_test_mesh(data=2, model=2, pod=2, device_type="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, s.shape, generator=gen, dtype=s.dtype)
             for k, s in C.input_specs(cfg, shape)["batch"].items()}
    opt = D._opt(cfg)
    step, state_sh, _ = TR.build_sharded_step(cfg, opt, mesh, M.param_specs(cfg), batch,
                                              device="cpu")
    # allocation events from before the state is drawn, so that every
    # block the step frees was allocated under the profiler
    prof = profile(activities=[ProfilerActivity.CPU], profile_memory=True)
    prof.__enter__()
    state = TR.sharded_init(mesh, opt, cfg, state_sh, device="cpu")
    payload, counts, inside = {}, {}, []

    def wrap(kind, fn, operand):
        def call(*a, **k):
            if inside:
                t = a[operand]
                payload[kind] = payload.get(kind, 0) + t.numel() * t.element_size()
                counts[kind] = counts.get(kind, 0) + 1
            return fn(*a, **k)
        return call

    dist.all_reduce = wrap("all-reduce", dist.all_reduce, 0)
    CC._ALL_GATHER = AX._ALL_GATHER = wrap("all-gather", CC._ALL_GATHER, 1)
    CC._REDUCE_SCATTER = AX._REDUCE_SCATTER = wrap("reduce-scatter", CC._REDUCE_SCATTER, 1)
    inside.append(True)
    # the dry-run's own count over the real tensors, beside the profiler's
    known = [TR._to_local(t) for t in T.leaves(state)] + list(batch.values())
    with record_function("counted_step"), FlopCounterMode(display=False) as fc, \
            H.StepCounter(known=known) as counter:
        step(state, batch)
    inside.clear()
    prof.__exit__(None, None, None)
    events = list(prof.profiler.kineto_results.events())
    span = next(e for e in events if e.name() == "counted_step")
    now = start = peak = 0
    for e in sorted((e for e in events if e.name() == "[memory]"), key=lambda e: e.start_ns()):
        if e.start_ns() > span.end_ns():
            break
        now += e.nbytes()
        if e.start_ns() < span.start_ns():
            start = peak = now
        peak = max(peak, now)
    if rank == 0:
        open(f"{tmp}/real.json", "w").write(json.dumps({
            "payload": payload, "counts": counts, "flops": fc.get_total_flops(),
            "peak_growth": peak - start, "counted_peak": counter.peak_bytes}))
""")


def _script(body: str) -> str:
    return body.replace("{arch}", COUNT_ARCH).replace("{seq}", str(COUNT_SEQ)).replace(
        "{batch}", str(COUNT_BATCH)).replace("{kseq}", str(KERNEL_SEQ)).replace(
        "{kbatch}", str(KERNEL_BATCH)).replace("{kcells}", repr(KERNEL_CELLS))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dryrun")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", PYTHONFAULTHANDLER="1")
    env.pop("XLA_FLAGS", None)
    dry = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    cmds = {"ref": [sys.executable, "-c", REF_SCRIPT, str(tmp)],
            "fake": [sys.executable, "-c", _script(FAKE_SCRIPT), str(tmp)],
            "full": dry + ["--arch", "yi-6b", "--shape", "decode_32k", "--mesh", "single",
                           "--out", str(tmp / "full")],
            "reduced": dry + ["--arch", "yi-6b", "--shape", "prefill_32k", "--mesh", "both",
                              "--reduced", "--out", str(tmp / "reduced")],
            "tagged": dry + ["--arch", "yi-6b", "--shape", "prefill_32k", "--mesh", "both",
                             "--reduced", "--tag", "variant", "--out", str(tmp / "reduced")]}
    (tmp / "ranks.py").write_text(_script(RANK_SCRIPT))
    cmds.update({f"rank{r}": [sys.executable, str(tmp / "ranks.py"), str(r), str(WORLD),
                              str(tmp)] for r in range(WORLD)})
    procs = {}
    for name, cmd in cmds.items():
        log = open(tmp / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(cmd, env=env, cwd=tmp, stdout=log,
                                        stderr=subprocess.STDOUT,
                                        preexec_fn=lambda: os.nice(19)), log)
    failed = []
    for name, (p, log) in procs.items():
        try:
            rc = p.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q, _ in procs.values():
                q.kill()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append(f"--- {name} ({rc}):\n{(tmp / f'{name}.log').read_text()[-3000:]}")
    assert not failed, "\n".join(failed)
    return {"tmp": tmp, "ref": json.loads((tmp / "ref.json").read_text()),
            "fake": json.loads((tmp / "fake.json").read_text()),
            "real": json.loads((tmp / "real.json").read_text())}


def test_count_step_collectives_match_real_ranks(runs):
    """The c10d payloads and counts of the fake rank, by kind, equal what
    the same step at 8 gloo ranks hands to c10d; `count_step` rings them
    as the reference's `analyze_hlo` does."""
    fake, real = runs["fake"], runs["real"]
    assert fake["payload"] == real["payload"]
    assert fake["counts"] == real["counts"]
    assert set(real["payload"]) == {"all-reduce", "all-gather", "reduce-scatter"}
    stats = fake["stats"]
    assert {k: v for k, v in stats["collective_op_counts"].items() if v} == real["counts"]
    assert stats["collective_bytes"] == stats["collective_bytes_raw"] > 0
    assert stats["collective_bytes"] == pytest.approx(sum(stats["collective_op_bytes"].values()))
    assert set(stats["collective_dtype_bytes"]) == {"f32"}
    assert fake["groups"] and max(fake["groups"]) <= WORLD and stats["max_trip"] == 2


def test_count_step_dot_flops_match_flop_counter(runs):
    """`dot_flops` of the fake rank equals `FlopCounterMode`'s count of the
    real rank's step; `count_step` gives what `measure`'s counter gave."""
    fake = runs["fake"]
    assert fake["dot_flops"] == runs["real"]["flops"] > 0
    assert fake["stats"]["dot_flops"] == fake["dot_flops"]
    assert fake["stats"]["dot_bytes"] > 0 and fake["stats"]["op_result_bytes"] > 0


def test_temp_bytes_match_a_real_ranks_peak(runs):
    """The fake rank's `temp_size_in_bytes` (the peak of the live bytes its
    step made) equals the same count over the real rank 0's tensors, and
    the most bytes that rank had allocated in the step beyond what it held
    when the step began (`torch.profiler`) is no lower and at most
    `TEMP_FACTOR` times higher."""
    temp = runs["fake"]["memory"]["temp_size_in_bytes"]
    real = runs["real"]
    print(f"temp_size_in_bytes {temp}, real peak growth {real['peak_growth']} "
          f"({real['peak_growth'] / temp:.4f}x)")
    assert temp == real["counted_peak"] > 0
    assert temp <= real["peak_growth"] <= TEMP_FACTOR * temp, (temp, real)


def _masked_pairs(sq: int, sk: int, causal: bool, window: int, q_offset: int) -> int:
    """The (query, key) pairs `kernels.ref.attention_ref`'s mask keeps,
    counted on the mask itself."""
    qp = q_offset + np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), dtype=bool)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= kp > qp - window
    return int(keep.sum())


def test_kernel_cells_count_the_kernels_as_the_card_runs_them(runs):
    """`measure` of reduced cells with the kernels on: each kernel is
    counted through its custom operator (`by_op`: `FlopCounterMode` over
    the same fake step, whose total equals the counter's); the aligned
    yi-6b cell counts `photonic_mac` where its plain version counts the
    dequantised `mm` and the attention's kept pairs where the plain
    version counts every pair, and holds no S x S scores (fewer temporary
    bytes)."""
    cells = runs["fake"]["kernel_cells"]
    for c in cells:
        assert c["dot_flops"] == c["flop_counter"] > 0, c
    on, off, zamba = cells
    assert on["kernels"] and not off["kernels"] and zamba["kernels"]
    assert {"repro_torch.photonic_mac", "repro_torch.flash_attention"} <= set(on["by_op"])
    assert not any(k.startswith("repro_torch.") for k in off["by_op"])
    assert {"repro_torch.ssm_scan", "repro_torch.flash_attention"} <= set(zamba["by_op"])
    assert on["by_op"]["repro_torch.photonic_mac"] + on["by_op"].get("aten.mm", 0) \
        == off["by_op"]["aten.mm"]
    s, pairs = KERNEL_SEQ, _masked_pairs(KERNEL_SEQ, KERNEL_SEQ, True, 0, 0)
    # one row and half the heads a rank: batch 4 over (pod 2, data 2), heads over model 2
    dense = on["n_layers"] * 4 * 1 * (on["heads"] // 2) * on["head_dim"] * s * s
    assert off["by_op"]["aten.bmm"] == dense
    assert on["by_op"]["repro_torch.flash_attention"] * s * s == dense * pairs
    assert on["memory"]["temp_size_in_bytes"] < off["memory"]["temp_size_in_bytes"]


def _scan_definition(x, a, b, c):
    """S_t = a_t S_{t-1} + x_t b_t^T, y_t = S_t c_t, both products written
    as the matmuls they are (an outer product is a (P, 1) by (1, N) one)."""
    bh, l, p = x.shape
    s = torch.zeros((bh, p, b.shape[-1]))
    ys = []
    for t in range(l):
        s = a[:, t, None, None] * s + torch.bmm(x[:, t, :, None], b[:, t, None, :])
        ys.append(torch.bmm(s, c[:, t, :, None])[..., 0])
    return torch.stack(ys, dim=1)


# (kernel, shapes and options) of the custom operators' counts
KERNEL_OPS = {
    "photonic_mac": {"m": 64, "k": 256, "n": 384},
    "flash_attention-causal": {"sq": 64, "sk": 64, "causal": True, "window": 0, "q_offset": 0},
    "flash_attention-window": {"sq": 64, "sk": 64, "causal": True, "window": 24, "q_offset": 0},
    "flash_attention-offset": {"sq": 64, "sk": 128, "causal": True, "window": 0,
                               "q_offset": 64},
    "flash_attention-bidirectional": {"sq": 64, "sk": 64, "causal": False, "window": 0,
                                      "q_offset": 0},
    "ssm_scan": {"bh": 6, "l": 16, "p": 8, "n": 4},
}


@pytest.mark.parametrize("case", list(KERNEL_OPS))
def test_kernel_operator_counted_as_its_plain_version(case):
    """Each kernel through `kernels.ops` under `FakeTensorMode` and a
    `StepCounter` (as the dry-run counts it): its result's shape and dtype
    are the plain version's on real tensors, and its FLOPs are
    `FlopCounterMode`'s count of the plain product: `photonic_mac` the
    dequantised matmul's; `flash_attention` the dense attention's times
    the fraction of pairs the mask keeps; `ssm_scan` the scan's definition
    with both products as matmuls (held against the sequential oracle)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.launch import hlo_analysis as H

    o = KERNEL_OPS[case]
    gen = torch.Generator().manual_seed(0)
    if case == "photonic_mac":
        m, k, n = o["m"], o["k"], o["n"]
        args = (torch.randn(m, k, generator=gen),
                torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8),
                torch.rand(k // 128, n // 128, generator=gen))
        kernel = lambda x, w, sc: ops._mac(x, w, sc, True)  # noqa: E731
        plain = R.photonic_mac_ref
        scale = 1
    elif case.startswith("flash_attention"):
        b, hq, hk, d = 2, 4, 2, 32
        args = (torch.randn(b, hq, o["sq"], d, generator=gen),
                torch.randn(b, hk, o["sk"], d, generator=gen),
                torch.randn(b, hk, o["sk"], d, generator=gen))
        opts = (o["causal"], o["window"], None, o["q_offset"])
        assert ops.uses_flash_kernel(o["sq"], o["sk"], o["q_offset"])
        kernel = lambda q, k, v: ops.attention(q, k, v, *opts, True)  # noqa: E731
        plain = lambda q, k, v: R.attention_ref(  # noqa: E731
            q, k, v, causal=o["causal"], window=o["window"], q_offset=o["q_offset"])
        scale = (_masked_pairs(o["sq"], o["sk"], o["causal"], o["window"], o["q_offset"]),
                 o["sq"] * o["sk"])
    else:
        bh, l, p, n = o["bh"], o["l"], o["p"], o["n"]
        args = (torch.randn(bh, l, p, generator=gen), torch.rand(bh, l, generator=gen),
                torch.randn(bh, l, n, generator=gen), torch.randn(bh, l, n, generator=gen))
        kernel = lambda x, a, b, c: ops.ssm(x, a, b, c, True)  # noqa: E731
        plain = _scan_definition
        torch.testing.assert_close(_scan_definition(*args), R.ssm_scan_ref(*args),
                                   rtol=1e-5, atol=1e-5)
        scale = 1
    with FlopCounterMode(display=False) as fc:
        want = plain(*args)
    with FakeTensorMode() as mode:
        fakes = [mode.from_tensor(t) for t in args]
        with H.StepCounter() as counter:
            got = kernel(*fakes)
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    flops = fc.get_total_flops()
    assert flops > 0
    if isinstance(scale, tuple):
        kept, total = scale
        assert (flops * kept) % total == 0
        flops = flops * kept // total
    assert counter.dot_flops == flops, (counter.dot_flops, flops)


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_argument_bytes_match_reference(runs, cell):
    """A device's shards of the arguments of the cell's step, in bytes,
    equal the reference's shard bytes of the arguments it lowers with."""
    arch, shape, mesh = cell
    got = D.argument_bytes(D.cell_config(arch), C.SHAPES[shape], D.production_geometry(mesh))
    assert got == runs["ref"][f"bytes|{arch}|{shape}|{mesh}"]


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_input_specs_match_reference(runs, cell):
    """`input_specs`' shapes and dtypes, leaf for leaf, against the
    reference's."""
    arch, shape, mesh = cell
    specs = C.input_specs(C.get(arch), C.SHAPES[shape])
    got = {path: [list(s.shape), str(s.dtype).removeprefix("torch.")]
           for path, s in T.leaves_with_path(specs)}
    assert got == runs["ref"][f"specs|{arch}|{shape}|{mesh}"]


def test_full_size_cell_record(runs):
    """yi-6b decode_32k single at full size: the reference's record, field
    for field, on 256 devices; its argument bytes the reference's."""
    rec = json.loads((runs["tmp"] / "full" / "yi_6b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == REF_RECORD_FIELDS
    assert set(rec["memory"]) == REF_MEMORY_FIELDS
    assert rec["n_devices"] == 256 and rec["compile_s"] == 0
    assert rec["memory"]["generated_code_size_in_bytes"] is None
    assert rec["memory"]["argument_size_in_bytes"] == runs["ref"]["bytes|yi_6b|decode_32k|single"]
    assert rec["memory"]["alias_size_in_bytes"] > 0        # the cache, updated in place
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert rec["hlo_stats"]["max_trip"] == 32
    assert rec["hlo_stats"]["collective_op_counts"]["all-gather"] > 0


def test_roofline_reads_the_port_dryrun(runs):
    """Two reduced cells, each with and without `--tag`: the roofline bench
    reads the port's records, the tagged ones only when asked."""
    import benchmarks.torch_roofline as R

    out = R.run(csv=False, device="cpu", artifacts=runs["tmp"] / "reduced")
    assert out["n_ok"] == 2 and out["n_err"] == 0
    cells = R.load_cells(include_tagged=True, artifacts=runs["tmp"] / "reduced")
    assert len(cells) == 4 and {c["tag"] for c in cells} == {"", "variant"}
    assert {c["n_devices"] for c in cells} == {256, 512}
    assert len(out["fabric"]) == 2 * len(R.FABRIC_NAMES)


def test_chunk_program_matches_eager_chunks():
    """`CodesignChunk` on the CPU against `network_columns_device` and
    `evaluate_accelerator_grid` run eagerly on the same rows, bit for bit,
    every chunk of the smoke grid including a padded last one."""
    import benchmarks.torch_pareto_bench as pb
    from repro_torch.core import CNN_WORKLOADS
    from repro_torch.core.accelerator import CodesignChunk, evaluate_accelerator_grid
    from repro_torch.core.sweep import grid_spec, network_columns_device

    wl, mixes = CNN_WORKLOADS["ResNet18"](), pb._mix_library(True)
    spec = grid_spec(pb.TOPOLOGIES, **pb.SMOKE_NET_AXES)
    chunk = 100
    assert spec.n % chunk
    program = CodesignChunk(wl, mixes, spec.topologies, chunk, device="cpu")
    for start in range(0, spec.n, chunk):
        stop = min(start + chunk, spec.n)
        cols, topo = spec.chunk_cols(start, stop)
        got = {k: v.clone() for k, v in program(cols, topo).items()}
        cols_t = {k: torch.as_tensor(v) for k, v in cols.items()}
        nets = network_columns_device(cols_t, topo, spec.topologies, device="cpu",
                                      as_numpy=False)
        want = evaluate_accelerator_grid(
            wl, mixes, nets, cols_t, cols_t["n_mem_chiplets"] * cols_t["mem_bw_bytes_per_s"],
            device="cpu", as_numpy=False)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == (len(mixes), stop - start)
            assert torch.equal(got[k], want[k]), (start, k)
