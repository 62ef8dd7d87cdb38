"""The engine's config axis sharded over a process group: the port's
`sweep_chunked(shard=True)` at 4 gloo ranks on the CPU against its own
world size 1 and `shard=False`, and against the JAX package's sharded run
over 4 forced host devices.

One module-scoped fixture starts at once the reference in a subprocess
(`XLA_FLAGS=--xla_force_host_platform_device_count=4`), the port as 4
gloo ranks (one process each, a `file://` rendezvous in the test's
temporary directory) and the port as a gloo world of 1.  Every process
runs `run_cases` below on the grid n_gateways=(8,16,32,64) x
n_lambda=(2,4,8,16) x five topologies (80 rows) and writes its results to
an npz there; this process runs it with no process group, sharded and not.

The cases: a `MinReducer` over one traffic; a collecting reducer (every
chunk's start, topology ids, network fields and metrics) over two
traffics at `chunk_size` 37, which rounds to 40 at 4 ranks, and at 27,
which rounds to 28 and pads the last chunk; a faulted `columns_fn` under
an (S=3, 1) Monte-Carlo scenario (composed on the device); a legacy
`columns_fn` (host numpy hook) under the expected scenario; and the
search's Pareto front through `pareto_search(shard=True)`.

Tolerances: every rank bit for bit the world of 1; the world of 1 bit for
bit `shard=False`; the reference's sharded run at rtol 1e-12, atol 0 (the
engine's tolerance against the reference elsewhere), indices and chunk
starts exactly.  This module never imports jax: the reference runs in its
subprocess, and the rank scripts import this module for `run_cases`.
"""

import importlib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 300
RTOL = 1e-12
AXES = dict(n_gateways=(8, 16, 32, 64), n_lambda=(2, 4, 8, 16))
CHUNKS = (37, 27)
ROUNDED = {37: 40, 27: 28}
FAULTS = dict(p_lambda=0.15, p_bank=0.12, p_gateway=0.05, wpe_loss=0.2,
              drift_sigma_db=0.5, tuning_sigma=0.3)
CASES = ("min", "collect37", "collect27", "faulted", "legacy", "front")


def run_cases(pkg: str, shard: bool, **device) -> dict:
    """Every case through `pkg` ("repro" or "repro_torch"; `device` is the
    port's keyword), flattened to "<case>/<key>" arrays."""
    S = importlib.import_module(f"{pkg}.core.sweep")
    F = importlib.import_module(f"{pkg}.core.faults")
    SR = importlib.import_module(f"{pkg}.core.search")
    cnn = importlib.import_module(f"{pkg}.core.workloads").CNN_WORKLOADS

    class Collect(S.ChunkReducer):
        def init(self, spec):
            return []

        def step(self, carry, chunk):
            carry.append({"start": np.array([chunk.start]), "topo_id": np.array(chunk.topo_id),
                          **{f"net.{k}": np.array(v) for k, v in chunk.nets.items()},
                          **{k: np.array(v) for k, v in chunk.metrics.items()}})
            return carry

        def finish(self, carry, spec):
            return {k: np.concatenate([c[k] for c in carry], axis=-1) for k in carry[0]}

    one = cnn["ResNet18"]().traffic()
    two = [cnn[k]().traffic() for k in ("ResNet18", "VGG16")]
    model = F.FaultModel(**FAULTS)
    hook = F.faulted_columns_fn(model.expected())

    def legacy(cols, topo_id, topologies):  # a plain callable: host columns
        return hook(cols, topo_id, topologies)

    kw = dict(shard=shard, prefetch=2, **device, **AXES)
    out = {}
    best = S.sweep_chunked(one, S.MinReducer("energy_j"), chunk_size=37, **kw)
    out["min/value"], out["min/index"] = np.array(best["value"]), np.array(best["index"])
    for chunk in CHUNKS:
        for k, v in S.sweep_chunked(two, Collect(), chunk_size=chunk, **kw).items():
            out[f"collect{chunk}/{k}"] = v
    for case, fn in (("faulted", F.faulted_columns_fn(model.sample(3, rng=0))),
                     ("legacy", legacy)):
        for k, v in S.sweep_chunked(one, Collect(), chunk_size=37, columns_fn=fn,
                                    **kw).items():
            out[f"{case}/{k}"] = v
    front = SR.pareto_search(one, chunk_size=37, **kw)
    order = np.argsort(front.indices)
    out["front/indices"], out["front/points"] = front.indices[order], front.points[order]
    return out


RANK_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, tmp, tests = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous{world}", rank=rank,
                            world_size=world)
    sys.path.insert(0, tests)
    import test_torch_shard as T
    from repro_torch.core import sweep as S

    mesh = S._config_mesh("cpu")
    out = T.run_cases("repro_torch", True, device="cpu")
    out["mesh"] = np.array(None if mesh is None else [mesh.size(), mesh.get_local_rank()])
    np.savez(f"{tmp}/port_w{world}_r{rank}.npz", **out)
    dist.destroy_process_group()
""")

REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import numpy as np
    assert jax.device_count() == 4, jax.device_count()
    tmp, tests = sys.argv[1], sys.argv[2]
    sys.path.insert(0, tests)
    import test_torch_shard as T
    np.savez(f"{tmp}/ref.npz", **T.run_cases("repro", True))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_shard")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", PYTHONFAULTHANDLER="1")
    env.pop("XLA_FLAGS", None)
    (tmp / "ranks.py").write_text(RANK_SCRIPT)
    tests = str(REPO / "tests")
    cmds = {"ref": [sys.executable, "-c", REF_SCRIPT, str(tmp), tests],
            "w1": [sys.executable, str(tmp / "ranks.py"), "0", "1", str(tmp), tests]}
    cmds.update({f"rank{r}": [sys.executable, str(tmp / "ranks.py"), str(r), str(WORLD),
                              str(tmp), tests] for r in range(WORLD)})
    procs = {}
    for name, cmd in cmds.items():
        log = open(tmp / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT),
                       log)
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
    load = lambda name: dict(np.load(tmp / f"{name}.npz", allow_pickle=True))  # noqa: E731
    return {"ref": load("ref"), "w1": load("port_w1_r0"),
            "ranks": [load(f"port_w{WORLD}_r{r}") for r in range(WORLD)],
            "plain": run_cases("repro_torch", False, device="cpu"),
            "no_group": run_cases("repro_torch", True, device="cpu")}


def _keys(out: dict, case: str) -> list:
    keys = [k for k in out if k.split("/")[0] == case]
    assert keys, case
    return keys


def _same(got: dict, want: dict, case: str, what: str) -> None:
    assert set(_keys(got, case)) == set(_keys(want, case)), what
    for k in _keys(want, case):
        assert got[k].dtype == want[k].dtype, f"{what}: {k}"
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")


@pytest.mark.parametrize("rank", range(WORLD))
def test_rank_sees_the_config_mesh(runs, rank):
    """Each rank's `_config_mesh` is the whole world, its coordinate the
    rank; a world of 1 has none."""
    assert runs["ranks"][rank]["mesh"].tolist() == [WORLD, rank]
    assert runs["w1"]["mesh"].item() is None


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("rank", range(WORLD))
def test_chunk_size_rounds_up_to_the_world(runs, chunk, rank):
    """At 4 ranks 37 rounds to 40 and 27 to 28 (the last chunk padded), as
    the reference rounds to its device count; a world of 1 keeps the size."""
    starts = runs["ranks"][rank][f"collect{chunk}/start"]
    np.testing.assert_array_equal(starts, np.arange(0, 80, ROUNDED[chunk]))
    np.testing.assert_array_equal(runs["ref"][f"collect{chunk}/start"], starts)
    np.testing.assert_array_equal(runs["w1"][f"collect{chunk}/start"],
                                  np.arange(0, 80, chunk))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rank", range(WORLD))
def test_every_rank_equals_world_one(runs, case, rank):
    """Each rank folds the whole gathered chunk: its result is the world
    of 1's bit for bit (the chunk starts aside, which follow the rounding)."""
    got, want = runs["ranks"][rank], runs["w1"]
    keys = [k for k in _keys(want, case) if not k.endswith("/start")]
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"rank {rank}: {k}")


@pytest.mark.parametrize("case", CASES)
def test_world_one_and_no_group_equal_unsharded(runs, case):
    """At world size 1, and with no process group, `shard=True` is today's
    path: bit for bit `shard=False`."""
    _same(runs["w1"], runs["plain"], case, "world 1 vs shard=False")
    _same(runs["no_group"], runs["plain"], case, "no group vs shard=False")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rank", (0, WORLD - 1))
def test_sharded_matches_reference(runs, case, rank):
    """A rank's result against the reference's 4-device sharded run:
    floats at rtol 1e-12, indices, topology ids and starts exactly."""
    got, want = runs["ranks"][rank], runs["ref"]
    assert set(_keys(got, case)) == set(_keys(want, case))
    for k in _keys(want, case):
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
