"""Dry-run of every (architecture x input shape) cell on the production
meshes, as one rank of a fake process group, and its roofline terms.

  single-pod: (16, 16)    ("data", "model")        256 ranks
  multi-pod : (2, 16, 16) ("pod", "data", "model") 512 ranks

The counterpart of the JAX package's `launch/dryrun.py`, which lowers and
compiles each cell's real step against abstract inputs and reads memory,
cost and the collective schedule from XLA.  Here one process plays rank 0
of the production mesh:

  * it opens a process group of PyTorch's "fake" backend
    (`init_process_group("fake", store=FakeStore(), rank=0, world_size=256
    or 512)`): every collective returns at once, moving nothing;
  * it builds the mesh (`launch.mesh.make_production_mesh(device_type=
    "cpu")`) and every flattened sub-mesh group up front
    (`collectives.prepare_axis_groups`), outside the fake tensors;
  * under `FakeTensorMode` it builds and runs the cell's real step once
    (`_lower_cell`), allocating nothing: `train` is
    `runtime.trainer.build_sharded_step` on a state from `sharded_init`
    (the optimizer state in bf16 when the config's FSDP axes include `pod`,
    f32 otherwise, as the reference chooses; the parameter wire when
    `cfg.wire_bits`); `prefill` and `decode`/`long_decode` are
    `serve.sharded`'s builders, on the rank's parameter and cache shards;
  * one `hlo_analysis.StepCounter` over the step gives every `HloStats`
    field and the peak of the live bytes.

The inputs are `configs.input_specs`' records as fake tensors (the global
batch; the step takes its rank's shard).  The config runs with its
kernels on (`use_kernels=True`), as on the card: the three hand-written
kernels are custom operators (`kernels.ops`) whose fake implementations
give their outputs' shapes and whose FLOP formulas count them, so nothing
builds or launches a kernel, and the plain attention's S x S scores never
enter the counts.

The record (`run_cell`) has the reference's fields: `status`,
`skip_reason` (`configs.supports_shape`), `n_devices`, `lower_s` (build and
run), `compile_s` (0: nothing compiles), `memory` (`argument_size_in_bytes`:
the rank's state or parameter shards and its batch or cache shards, equal
to `argument_bytes`' count from the shardings alone; `output_size_in_bytes`;
`alias_size_in_bytes`, the outputs that are arguments updated in place;
`temp_size_in_bytes`, the peak of live bytes the step made;
`generated_code_size_in_bytes` null), `cost_flops` (the counted FLOPs:
the flop counter has formulas for the matmul-class ops alone),
`cost_bytes` (every op's result bytes, no fusion), `hlo_stats` and
`roofline` (`hlo_analysis.roofline` on the metallic default fabric, with
the arguments and outputs as I/O).  These are host-side counts priced on
the modelled TPU-class fabric constants of `core.fabric`, not times of any
card.

Usage (CPU only; no card, no kernel build):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
Artifacts: benchmarks/artifacts/torch_dryrun/<arch>__<shape>__<mesh>[__<tag>].json
(`--out` another directory; `--reduced` runs each config's CPU-scale
version on the same meshes, for tests).
With `--all` (or several cells) each cell runs in a process of its own, so
that one cell's failure or memory cannot touch the next; a failed cell is
recorded with `status: "error"` and its traceback, and counted in the exit
code.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import configs as C
from repro_torch import tree as T
from repro_torch.launch import hlo_analysis as H
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as S
from repro_torch.parallel.collectives import MeshGeometry, mesh_axis_sizes

__all__ = ["model_flops_per_device", "ARTIFACTS", "production_geometry", "argument_bytes",
           "cell_config", "measure", "run_cell", "main"]

ARTIFACTS = Path(__file__).resolve().parents[3] / "benchmarks" / "artifacts" / "torch_dryrun"


def model_flops_per_device(cfg: ModelConfig, shape, n_devices: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for training;
    2*N*D for inference steps (forward only).  Per device."""
    n = cfg.active_param_count() if cfg.n_experts else cfg.param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        total = 6.0 * n * d
    elif shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        total = 2.0 * n * d
    else:  # decode: one token per sequence
        d = shape.global_batch * 1
        total = 2.0 * n * d
    return total / n_devices


def production_geometry(mesh_kind: str) -> MeshGeometry:
    """The production mesh's shape, without a process group."""
    if mesh_kind == "multi":
        return MeshGeometry((2, 16, 16), ("pod", "data", "model"))
    return MeshGeometry((16, 16), ("data", "model"))


def cell_config(arch: str, strategy=None, remat=None, wire_bits=None,
                moe_dispatch=None, reduced: bool = False) -> ModelConfig:
    """The config a cell runs: the published one (or its reduced version)
    with the flags' overrides and its kernels on."""
    cfg = dataclasses.replace(C.get_reduced(arch) if reduced else C.get(arch),
                              use_kernels=True)
    if strategy:
        cfg = dataclasses.replace(cfg, parallel_strategy=strategy)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    if wire_bits is not None:
        cfg = dataclasses.replace(cfg, wire_bits=wire_bits)
    if moe_dispatch:
        cfg = dataclasses.replace(cfg, moe_dispatch=moe_dispatch)
    return cfg


def _opt(cfg: ModelConfig, opt_dtype=None) -> adamw.OptConfig:
    return adamw.OptConfig(state_dtype=opt_dtype or (
        "bfloat16" if "pod" in cfg.fsdp_axes else "float32"))


def _local_shape(sizes: Dict[str, int], spec, shape) -> tuple:
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for d, part in zip(shape, spec):
        axes = () if part is None else (part,) if isinstance(part, str) else tuple(part)
        out.append(d // math.prod(sizes[a] for a in axes))
    return tuple(out)


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


@functools.lru_cache(maxsize=None)
def _abstract(cfg: ModelConfig):
    """`init_abstract`'s (shapes, specs), once a config."""
    return M.init_abstract(cfg)


def _cell_layout(cfg: ModelConfig, shape, mesh, opt_dtype=None):
    """[(global shape, dtype, sharding)] of every argument of the cell's
    step on `mesh` (a `DeviceMesh` or a geometry), in the order the step
    takes them (`configs.input_specs`' inputs).  The parameters
    (and the moments, which `optim.adamw.state_specs` lays out alike) as
    `enforce_divisibility(tree_shardings(mesh, param_specs, rules))`."""
    specs = C.input_specs(cfg, shape)
    shapes, pspecs = _abstract(cfg)
    param_sh = T.leaves(S.enforce_divisibility(
        S.tree_shardings(mesh, pspecs, S.rules_for(cfg, mesh)), shapes))
    leaves = T.leaves(shapes)
    out = []
    if shape.kind == "train":
        opt = _opt(cfg, opt_dtype)
        sdt = torch.bfloat16 if opt.state_dtype == "bfloat16" else torch.float32
        out.append(((), torch.int32, S.NamedSharding(mesh, S.P())))
        for dt in (None, sdt, sdt):
            for leaf, sh in zip(leaves, param_sh):
                out.append((tuple(leaf.shape), dt or leaf.dtype, sh))
        batch_sh = S.train_batch_shardings(cfg, mesh, specs["batch"])
        for k, spec in specs["batch"].items():
            out.append((spec.shape, spec.dtype, batch_sh[k]))
        return out
    from repro_torch.serve import sharded as SV

    for leaf, sh in zip(leaves, param_sh):
        out.append((tuple(leaf.shape), leaf.dtype, sh))
    if shape.kind == "prefill":
        batch_sh = S.train_batch_shardings(cfg, mesh, specs["batch"])
        for k, spec in specs["batch"].items():
            out.append((spec.shape, spec.dtype, batch_sh[k]))
        return out
    b = shape.global_batch
    cache, _ = M.init_cache_abstract(cfg, b, shape.seq_len)
    cache_sh = SV.serve_cache_shardings(cfg, mesh, cache)
    for leaf, sh in zip(T.leaves(cache), T.leaves(cache_sh)):
        out.append((tuple(leaf.shape), leaf.dtype, sh))
    tok_sh = S.train_batch_shardings(cfg, mesh, {"t": specs["tokens"]})["t"]
    out.append((specs["tokens"].shape, specs["tokens"].dtype, tok_sh))
    out.append(((), torch.int32, S.NamedSharding(mesh, S.P())))
    if cfg.encoder_layers:
        enc_sh = S.train_batch_shardings(cfg, mesh, {"e": specs["enc_out"]})["e"]
        out.append((specs["enc_out"].shape, specs["enc_out"].dtype, enc_sh))
    return out


def argument_bytes(cfg: ModelConfig, shape, mesh, opt_dtype=None) -> int:
    """The bytes of the rank's shards of every argument of the cell's step
    (the reference's `argument_size_in_bytes`), from the shardings alone:
    `mesh` may be a geometry (`production_geometry`)."""
    sizes = mesh_axis_sizes(mesh)
    layout = _cell_layout(cfg, shape, mesh, opt_dtype)
    return sum(_bytes(_local_shape(sizes, sh.spec, shp), dt) for shp, dt, sh in layout)


def _fake_world(n_devices: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is open; "
                               f"this cell needs {n_devices}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_devices)


def _fake(spec) -> torch.Tensor:
    """A tensor of `spec`'s shape and dtype (inside `FakeTensorMode`: no storage)."""
    return torch.zeros(spec.shape, dtype=spec.dtype)


def _lower_cell(cfg: ModelConfig, shape, mesh, opt_dtype=None):
    """(step, its arguments) for the cell, built inside the caller's
    `FakeTensorMode`: `step()` runs the cell's real step once on them."""
    from repro_torch.runtime import trainer as TR
    from repro_torch.serve import sharded as SV

    sizes = mesh_axis_sizes(mesh)
    specs = C.input_specs(cfg, shape)
    cpu = torch.device("cpu")

    def local_params():
        shapes, _ = M.init_abstract(cfg)
        return T.map_structure(
            lambda leaf, sh: torch.zeros(_local_shape(sizes, sh.spec, leaf.shape),
                                         dtype=leaf.dtype),
            shapes, SV.param_shardings(cfg, mesh))

    if shape.kind == "train":
        opt = _opt(cfg, opt_dtype)
        batch = {k: _fake(s) for k, s in specs["batch"].items()}
        step, state_sh, batch_sh = TR.build_sharded_step(cfg, opt, mesh, M.param_specs(cfg),
                                                         batch, device=cpu)
        state = TR.sharded_init(mesh, opt, cfg, state_sh, device=cpu)
        local = [TR._to_local(t) for t in T.leaves(state)]
        local += [S.local_shard(mesh, batch_sh[k].spec, v) for k, v in batch.items()]
        return (lambda: step(state, batch)), local

    params = local_params()
    if shape.kind == "prefill":
        batch = {k: _fake(s) for k, s in specs["batch"].items()}
        prefill, _, batch_sh, _ = SV.build_sharded_prefill(cfg, mesh, None, batch,
                                                           shape.seq_len + 1, device=cpu)
        local = T.leaves(params) + [S.local_shard(mesh, batch_sh[k].spec, v)
                                    for k, v in batch.items()]
        return (lambda: prefill(params, batch)), local

    b = shape.global_batch
    cache_abstract, _ = M.init_cache_abstract(cfg, b, shape.seq_len)
    serve, _, cache_sh, tok_sh = SV.build_sharded_serve_step(cfg, mesh, None, cache_abstract,
                                                              device=cpu)
    cache = T.map_structure(
        lambda leaf, sh: torch.zeros(_local_shape(sizes, sh.spec, leaf.shape), dtype=leaf.dtype),
        cache_abstract, cache_sh)
    tokens = _fake(specs["tokens"])
    pos = torch.zeros((), dtype=torch.int32)
    enc = _fake(specs["enc_out"]) if cfg.encoder_layers else None
    local = T.leaves(params) + T.leaves(cache) + [S.local_shard(mesh, tok_sh.spec, tokens), pos]
    if enc is not None:
        local.append(S.local_shard(mesh, tok_sh.spec, enc))
    # the last position of the cache: a rolling cache rolls, as in steady state
    last = shape.seq_len - 1
    return (lambda: serve(params, cache, tokens, last, enc_out=enc)), local


def _layer_trips(cfg: ModelConfig) -> int:
    """The most times one layer body runs in a step: the longest stage's
    repeat, or the encoder's depth."""
    return max([repeat for repeat, _ in M.stages(cfg)] + [cfg.encoder_layers])


def measure(cfg: ModelConfig, shape, mesh, opt_dtype=None):
    """Build and run the cell's step once under `FakeTensorMode` on `mesh`
    (a `DeviceMesh` over a fake process group, its flattened groups made:
    `collectives.prepare_axis_groups`).  Returns (the `StepCounter`, the
    `memory` fields, the seconds it took)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.runtime import trainer as TR

    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = _lower_cell(cfg, shape, mesh, opt_dtype)
        arg_bytes = sum(t.numel() * t.element_size() for t in args)
        arg_ids = {id(t.untyped_storage()) for t in args}
        with H.StepCounter(known=args) as counter:
            result = step()
        outs = [TR._to_local(t) for t in H._tensors(result)]
    seconds = time.perf_counter() - t0
    want = argument_bytes(cfg, shape, mesh, opt_dtype)
    if arg_bytes != want:
        raise AssertionError(f"the step's arguments hold {arg_bytes} bytes a rank; the "
                             f"shardings say {want}")
    out_bytes = sum(t.numel() * t.element_size() for t in outs)
    alias = sum(t.numel() * t.element_size() for t in outs
                if id(t.untyped_storage()) in arg_ids)
    memory = {"temp_size_in_bytes": int(counter.peak_bytes),
              "argument_size_in_bytes": int(arg_bytes),
              "output_size_in_bytes": int(out_bytes),
              "alias_size_in_bytes": int(alias),
              "generated_code_size_in_bytes": None}
    return counter, memory, seconds


def run_cell(arch: str, shape_name: str, mesh_kind: str, verbose=True, strategy=None,
             remat=None, opt_dtype=None, wire_bits=None, moe_dispatch=None,
             reduced: bool = False) -> dict:
    """One cell's record (module docstring), rank 0 of a fake process group
    of the production mesh's size (`reduced`: the config's CPU-scale
    version on the same mesh)."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.collectives import prepare_axis_groups

    cfg = cell_config(arch, strategy, remat, wire_bits, moe_dispatch, reduced)
    shape = C.SHAPES[shape_name]
    skip = C.supports_shape(cfg, shape)
    out = {"arch": cfg.name, "shape": shape_name, "mesh": mesh_kind,
           "strategy": strategy or cfg.parallel_strategy,
           "remat": cfg.remat, "opt_dtype": opt_dtype,
           "wire_bits": cfg.wire_bits,
           "status": "skip", "skip_reason": skip}
    if skip:
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {skip}")
        return out

    n_dev = math.prod(production_geometry(mesh_kind).devices.shape)
    _fake_world(n_dev)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")
    prepare_axis_groups(mesh)
    counter, mem_fields, t_lower = measure(cfg, shape, mesh, opt_dtype)
    stats = counter.stats(_layer_trips(cfg))
    arg_bytes = mem_fields["argument_size_in_bytes"]
    cost = {"flops": stats.dot_flops, "bytes accessed": stats.op_result_bytes}
    terms = H.roofline(stats, cost, model_flops_per_device(cfg, shape, n_dev),
                       io_bytes=arg_bytes + mem_fields["output_size_in_bytes"])
    out.update({
        "status": "ok",
        "n_devices": n_dev,
        "lower_s": t_lower,
        "compile_s": 0.0,
        "memory": mem_fields,
        "cost_flops": float(cost["flops"]),
        "cost_bytes": float(cost["bytes accessed"]),
        "hlo_stats": stats.to_json(),
        "roofline": terms.to_json(),
    })
    if verbose:
        print(f"[ok] {arch:20s} x {shape_name:12s} x {mesh_kind:6s} "
              f"args={arg_bytes / 2**30:6.2f}GiB/dev "
              f"compute={terms.compute_s*1e3:8.2f}ms "
              f"memory={terms.memory_s*1e3:8.2f}ms "
              f"collective={terms.collective_s*1e3:8.2f}ms "
              f"-> {terms.bottleneck} (built and counted in {t_lower:.0f}s)")
    return out


def _artifact(out_dir: Path, arch: str, shape: str, mesh_kind: str, tag: str) -> Path:
    return out_dir / (f"{arch}__{shape}__{mesh_kind}" + (f"__{tag}" if tag else "") + ".json")


def _cell_argv(args, arch: str, shape: str, mesh_kind: str) -> list:
    argv = ["--arch", arch, "--shape", shape, "--mesh", mesh_kind, "--tag", args.tag,
            "--out", args.out] + (["--reduced"] if args.reduced else [])
    for flag in ("strategy", "remat", "opt_dtype", "wire_bits", "moe_dispatch"):
        val = getattr(args, flag)
        if val is not None:
            argv += [f"--{flag.replace('_', '-')}", str(val)]
    return argv


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(C.SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--strategy", default=None,
                    choices=[None, "tp_fsdp", "fsdp_all", "seq_tp"])
    ap.add_argument("--remat", default=None,
                    choices=[None, "none", "full", "dots", "dots_all"])
    ap.add_argument("--opt-dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--wire-bits", default=None, type=int,
                    help="int8 weight wire format (fsdp_all only)")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "einsum", "index"])
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--reduced", action="store_true",
                    help="each config's reduced (CPU-scale) version, on the same meshes")
    ap.add_argument("--out", default=str(ARTIFACTS), help="the artifacts' directory")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    archs = list(C.ALIASES.keys()) if args.all or not args.arch else [args.arch]
    archs = sorted({C.ALIASES[a] for a in archs})
    shapes = list(C.SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if (args.mesh == "both" or args.all) else [args.mesh]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    out_dir.mkdir(parents=True, exist_ok=True)
    if len(cells) > 1:
        # one process a cell: a cell's failure or memory cannot touch the next
        failures = 0
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(Path(__file__).resolve().parents[2])] +
            [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        for arch, shape, mesh_kind in cells:
            rc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                                 *_cell_argv(args, arch, shape, mesh_kind)], env=env).returncode
            failures += rc != 0
        print(f"done; failures={failures}")
        return failures

    arch, shape, mesh_kind = cells[0]
    path = _artifact(out_dir, arch, shape, mesh_kind, args.tag)
    failures = 0
    try:
        res = run_cell(arch, shape, mesh_kind, strategy=args.strategy, remat=args.remat,
                       opt_dtype=args.opt_dtype, wire_bits=args.wire_bits,
                       moe_dispatch=args.moe_dispatch, reduced=args.reduced)
    except Exception as e:  # noqa: BLE001  (recorded, printed and counted in the exit code)
        failures += 1
        res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print(f"[ERROR] {path.stem}: {type(e).__name__}: {e}")
    path.write_text(json.dumps(res, indent=1))
    print(f"done; failures={failures}")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
