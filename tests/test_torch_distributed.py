"""The port's cross-device schedules against the JAX package's, at 8 ranks
on the CPU: `flat_all_reduce`, `trine_all_reduce` and
`compressed_all_reduce` on the (pod 2, data 2, model 2) test mesh, and
`pipelined_apply` forward and backward on a (pipe 4, data 2) mesh.

One module-scoped fixture runs both sides once, at the same time: the
reference in a subprocess with 8 forced host devices, the port as 8 gloo
ranks (one process each, a `file://` rendezvous in a temporary directory,
so that concurrent test workers never share a port).  Each writes its
results to files there; the parametrised tests below read them, rank by
rank.  The pipeline's mesh takes `AxisType.Auto` axes in the reference:
on this jax an Explicit-axis mesh (what `jax.make_mesh` gives) makes the
gradient through the shard_map raise.

Tolerances: the all-reduces at rtol 1e-6 (the reference test's); the
compressed all-reduce's output and residual at rtol 1e-6 with an atol of
1e-6 of the largest entry (int8 levels and scales are computed from the
same f32 sums); the pipeline at the reference test's 2e-5 forward and
5e-5 backward.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
TIMEOUT_S = 600
CHUNKS = (None, 64)
PIPE = dict(S=4, L=2, D=16, M=6, MB=8)

REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.launch.mesh import make_test_mesh
    from repro.parallel import collectives as CC
    from repro.parallel import pipeline as PP

    tmp = sys.argv[1]
    inp = dict(np.load(f"{tmp}/inputs.npz"))
    out = {}
    mesh = make_test_mesh(data=2, model=2, pod=2)
    out["flat"] = CC.flat_all_reduce(inp["x"], mesh)
    out["trine"] = CC.trine_all_reduce(inp["x"], mesh)
    for chunk in (None, 64):
        for res in ("none", "given"):
            r = None if res == "none" else inp["res_in"]
            o, nr = CC.compressed_all_reduce(inp["g"], mesh, residual=r, chunk_elems=chunk)
            out[f"comp_{chunk}_{res}_out"], out[f"comp_{chunk}_{res}_res"] = o, nr

    pmesh = jax.make_mesh((4, 2), ("pipe", "data"), axis_types=(AxisType.Auto,) * 2)
    params = {"w": inp["pw"], "b": inp["pb"]}

    def stage_fn(p, x):
        def layer(h, wl):
            w, b = wl
            return jnp.tanh(h @ w + b), None
        h, _ = jax.lax.scan(layer, x, (p["w"], p["b"]))
        return h

    xs = inp["px"]
    out["pipe_out"] = PP.pipelined_apply(stage_fn, params, xs, pmesh, axis="pipe")
    g = jax.grad(lambda p: jnp.sum(
        PP.pipelined_apply(stage_fn, p, xs, pmesh, axis="pipe") ** 2))(params)
    out["pipe_gw"], out["pipe_gb"] = g["w"], g["b"]
    np.savez(f"{tmp}/ref.npz", **{k: np.asarray(v) for k, v in out.items()})
""")

RANK_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.parallel import actx
    from repro_torch.parallel import collectives as CC
    from repro_torch.parallel import pipeline as PP
    from repro_torch.parallel import sharding as S

    inp = {k: torch.from_numpy(v) for k, v in np.load(f"{tmp}/inputs.npz").items()}
    out = {}
    mesh = make_test_mesh(data=2, model=2, pod=2, device_type="cpu")
    out["coord"] = np.array(mesh.get_coordinate())
    out["flat"] = CC.flat_all_reduce(inp["x"], mesh)
    out["trine"] = CC.trine_all_reduce(inp["x"], mesh)
    for chunk in (None, 64):
        for res in ("none", "given"):
            r = None if res == "none" else inp["res_in"]
            o, nr = CC.compressed_all_reduce(inp["g"], mesh, residual=r, chunk_elems=chunk)
            out[f"comp_{chunk}_{res}_out"], out[f"comp_{chunk}_{res}_res"] = o, nr
    mine = inp["distinct"][rank]
    out["flat_distinct"] = CC.flat_all_reduce(mine, mesh)
    out["trine_distinct"] = CC.trine_all_reduce(mine, mesh)
    out["flat_distinct_model"] = CC.flat_all_reduce(mine, mesh, axes=("model",))

    # a world size other than the mesh's raises
    for name, make in (("test", lambda: make_test_mesh(2, 2, 1, device_type="cpu")),
                       ("production", lambda: make_production_mesh(device_type="cpu"))):
        try:
            make()
            out[f"mismatch_{name}"] = np.array("no error")
        except ValueError as e:
            out[f"mismatch_{name}"] = np.array(str(e))

    # a DTensor constrained to batch-over-DP under the context
    full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    with actx.activation_sharding(mesh, ("pod", "data")):
        c = actx.constrain_batch(DTensor.from_local(full, mesh, [Replicate()] * 3,
                                                    run_check=False))
    out["constrained_local"] = c.to_local()
    out["constrained_want"] = S.local_shard(mesh, S.P(("pod", "data")), full)
    out["constrained_placements"] = np.array(str(list(c.placements)))

    pmesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("pipe", "data"))
    out["pipe_stage"] = np.array(pmesh.get_coordinate()[0])
    params = {"w": inp["pw"].clone().requires_grad_(True),
              "b": inp["pb"].clone().requires_grad_(True)}

    def stage_fn(p, x):
        h = x
        for l in range(p["w"].shape[0]):
            h = torch.tanh(h @ p["w"][l] + p["b"][l])
        return h

    y = PP.pipelined_apply(stage_fn, params, inp["px"], pmesh, axis="pipe")
    gw, gb = torch.autograd.grad(torch.sum(y ** 2), [params["w"], params["b"]])
    seq = PP.sequential_reference(stage_fn, params, inp["px"])
    sw, sb = torch.autograd.grad(torch.sum(seq ** 2), [params["w"], params["b"]])
    out.update(pipe_out=y, pipe_gw=gw, pipe_gb=gb, seq_out=seq, seq_gw=sw, seq_gb=sb)
    np.savez(f"{tmp}/port_{rank}.npz",
             **{k: v.detach().numpy() if torch.is_tensor(v) else v for k, v in out.items()})
    dist.destroy_process_group()
""")


def _run_both(tmp: Path, ref_script: str, rank_script: str, timeout_s: float = TIMEOUT_S):
    """The reference subprocess (`ref_script` with `tmp` as its argument)
    and the 8 port ranks (`rank_script` with the rank, the world size,
    `tmp` and this directory), started together; each's output goes to a
    log file.  Fails with the logs of any process that exits non-zero or
    outlives `timeout_s`."""
    # a rank that crashes prints its stack to its log (PYTHONFAULTHANDLER)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", PYTHONFAULTHANDLER="1")
    env.pop("XLA_FLAGS", None)
    (tmp / "ranks.py").write_text(rank_script)
    cmds = {"ref": [sys.executable, "-c", ref_script, str(tmp)]}
    cmds.update({f"rank{r}": [sys.executable, str(tmp / "ranks.py"), str(r), str(WORLD),
                              str(tmp), str(REPO / "tests")] for r in range(WORLD)})
    procs = {}
    for name, cmd in cmds.items():
        log = open(tmp / f"{name}.log", "w")
        # the lowest priority: the 9 processes must not take the CPU from
        # the timing-gated tests that run beside them (their ratio bars)
        procs[name] = (subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                                        preexec_fn=lambda: os.nice(19)), log)
    failed = []
    for name, (p, log) in procs.items():
        try:
            rc = p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            for q, _ in procs.values():
                q.kill()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append(f"--- {name} ({rc}):\n{(tmp / f'{name}.log').read_text()[-3000:]}")
    assert not failed, "\n".join(failed)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_distributed")
    rng = np.random.default_rng(0)
    s = PIPE
    inputs = {
        "x": rng.standard_normal((64, 33)).astype(np.float32),
        # an odd length: the data split pads, and a 64-element chunk pads
        "g": rng.standard_normal(257).astype(np.float32),
        "res_in": (0.01 * rng.standard_normal(257)).astype(np.float32),
        "distinct": rng.standard_normal((WORLD, 5, 7)).astype(np.float32),
        "pw": (rng.standard_normal((s["S"], s["L"], s["D"], s["D"])) * s["D"] ** -0.5
               ).astype(np.float32),
        "pb": (rng.standard_normal((s["S"], s["L"], s["D"])) * 0.01).astype(np.float32),
        "px": rng.standard_normal((s["M"], s["MB"], s["D"])).astype(np.float32),
    }
    np.savez(tmp / "inputs.npz", **inputs)
    _run_both(tmp, REF_SCRIPT, RANK_SCRIPT)
    return {"inputs": inputs, "ref": dict(np.load(tmp / "ref.npz")),
            "ranks": [dict(np.load(tmp / f"port_{r}.npz")) for r in range(WORLD)]}


RANKS = list(range(WORLD))


@pytest.mark.parametrize("rank", RANKS)
def test_flat_and_trine_all_reduce_match_reference(runs, rank):
    """The reference test's (64, 33) input, replicated: both schedules sum
    over the 4 (pod, data) ranks of the rank's model index."""
    got, ref, x = runs["ranks"][rank], runs["ref"], runs["inputs"]["x"]
    for key in ("flat", "trine"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(got["trine"], got["flat"], rtol=1e-6)
    np.testing.assert_allclose(got["flat"], 4 * x, rtol=1e-6)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("residual", ["none", "given"])
def test_compressed_all_reduce_matches_reference(runs, chunk, residual):
    """Output and new residual on every rank, against the reference's, for
    one global scale and for 64-element chunks, with and without an
    incoming residual; and the reference test's error bound."""
    ref = runs["ref"]
    g, res_in = runs["inputs"]["g"], runs["inputs"]["res_in"]
    for rank, got in enumerate(runs["ranks"]):
        for part in ("out", "res"):
            key = f"comp_{chunk}_{residual}_{part}"
            want = ref[key]
            np.testing.assert_allclose(got[key], want, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(want).max()),
                                       err_msg=f"rank {rank} {key}")
        exact = 4 * (g + (res_in if residual == "given" else 0))
        out = got[f"comp_{chunk}_{residual}_out"]
        assert np.abs(out - exact).max() <= 8 * np.abs(exact).max() / 127 + 1e-5


@pytest.mark.parametrize("rank", RANKS)
def test_distinct_inputs_sum_over_the_pod_and_data_ranks(runs, rank):
    """Each rank its own input: both schedules give the numpy sum over the
    ranks that share its model index; over `model` alone, the sum over the
    ranks that share its (pod, data)."""
    got = runs["ranks"][rank]
    coords = [tuple(r["coord"]) for r in runs["ranks"]]
    mine = coords[rank]
    xs = runs["inputs"]["distinct"]
    want = sum(xs[r] for r, c in enumerate(coords) if c[2] == mine[2])
    np.testing.assert_allclose(got["flat_distinct"], want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["trine_distinct"], want, rtol=1e-6, atol=1e-6)
    want_model = sum(xs[r] for r, c in enumerate(coords) if c[:2] == mine[:2])
    np.testing.assert_allclose(got["flat_distinct_model"], want_model, rtol=1e-6, atol=1e-6)


def test_ranks_sit_on_the_mesh_in_row_major_order(runs):
    assert [tuple(r["coord"]) for r in runs["ranks"]] == [
        (p, d, m) for p in range(2) for d in range(2) for m in range(2)]


@pytest.mark.parametrize("rank", RANKS)
def test_pipeline_forward_and_backward_match_reference(runs, rank):
    """`pipelined_apply` on the (pipe 4, data 2) mesh: the replicated
    outputs equal the reference's and `sequential_reference`'s on every
    rank; the rank's stage slice of each gradient equals the reference's,
    and the other slices are zero."""
    got, ref = runs["ranks"][rank], runs["ref"]
    np.testing.assert_allclose(got["pipe_out"], ref["pipe_out"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["pipe_out"], got["seq_out"], rtol=2e-5, atol=2e-5)
    s = int(got["pipe_stage"])
    for leaf in ("gw", "gb"):
        mine = got[f"pipe_{leaf}"]
        np.testing.assert_allclose(mine[s], ref[f"pipe_{leaf}"][s], rtol=5e-5, atol=5e-5)
        np.testing.assert_allclose(mine[s], got[f"seq_{leaf}"][s], rtol=5e-5, atol=5e-5)
        assert not np.delete(mine, s, axis=0).any()


def test_pipeline_gradients_cover_every_stage(runs):
    """Summed over the four pipe ranks of one data index (ranks 0, 2, 4, 6
    of the row-major (pipe, data) mesh), the gradients are the reference's
    whole (S, ...) gradients."""
    ranks = runs["ranks"][0::2]
    assert sorted(int(r["pipe_stage"]) for r in ranks) == list(range(PIPE["S"]))
    for leaf in ("gw", "gb"):
        total = sum(r[f"pipe_{leaf}"] for r in ranks)
        np.testing.assert_allclose(total, runs["ref"][f"pipe_{leaf}"], rtol=5e-5, atol=5e-5)


def test_mesh_of_another_world_size_raises(runs):
    got = runs["ranks"][0]
    assert "needs 4 ranks; the process group has 8" in str(got["mismatch_test"])
    assert "needs 256 ranks; the process group has 8" in str(got["mismatch_production"])


def test_constrain_redistributes_a_dtensor_to_batch_over_dp(runs):
    for got in runs["ranks"]:
        np.testing.assert_array_equal(got["constrained_local"], got["constrained_want"])
        assert str(got["constrained_placements"]) == "[Shard(dim=0), Shard(dim=0), Replicate()]"


# ---------------------------------------------------------------------------
# in this process: no process group
# ---------------------------------------------------------------------------


def test_mesh_without_a_process_group_raises():
    from repro_torch.launch.mesh import make_test_mesh

    with pytest.raises(RuntimeError, match="needs a process group of 8 ranks"):
        make_test_mesh(2, 2, 2, device_type="cpu")


def test_mesh_axis_sizes_read_a_geometry():
    from repro_torch.launch.mesh import has_pod_axis, mesh_axis_sizes
    from repro_torch.parallel.collectives import MeshGeometry

    g = MeshGeometry((2, 16, 16))
    assert mesh_axis_sizes(g) == {"pod": 2, "data": 16, "model": 16}
    assert has_pod_axis(g) and not has_pod_axis(MeshGeometry((16, 16), ("data", "model")))


def test_activation_constraints_are_no_ops_without_the_context():
    from repro_torch.parallel import actx

    x = torch.ones(2, 3, 4)
    assert not actx.active()
    for f in (actx.constrain_batch, actx.constrain_seq, actx.constrain_unseq):
        assert f(x) is x
    assert actx.constrain(x, ("dp", None, None)) is x


@pytest.mark.parametrize("dp", [("pod", "data"), ("data",), "data", None])
@pytest.mark.parametrize("seq_tp", [False, True])
def test_activation_constraints_resolve_as_the_reference(monkeypatch, dp, seq_tp):
    """The partition spec each constraint resolves to under the context, the
    reference's captured from its `with_sharding_constraint`; a plain
    tensor (a rank's own shard) comes back as it is."""
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.parallel import actx as JX

    from repro_torch.parallel import actx

    seen = []
    monkeypatch.setattr(JX, "NamedSharding", lambda mesh, ps: ps)
    monkeypatch.setattr(JX.jax.lax, "with_sharding_constraint",
                        lambda x, ps: seen.append(tuple(ps)) or x)
    x = torch.ones(2, 3, 4)
    cases = [("dp", None, None), ("dp", "tp", None), ("tp", "dp", None), (None, "tp", "tp")]
    with JX.activation_sharding("mesh", dp, seq_tp=seq_tp):
        for spec in cases:
            JX.constrain(np.ones((2, 3, 4)), spec)
        JX.constrain_batch(np.ones((2, 3)))
        JX.constrain_seq(np.ones((2, 3, 4)))
        JX.constrain_unseq(np.ones((2, 3, 4)))
    with actx.activation_sharding("mesh", dp, seq_tp=seq_tp):
        assert actx.active()
        mine = [tuple(actx.resolve(spec)) for spec in cases] + [tuple(actx.resolve(("dp", None)))]
        if seq_tp:
            mine += [tuple(actx.resolve(("dp", "tp", None))), tuple(actx.resolve(("dp", None, None)))]
        assert actx.constrain_seq(x) is x and actx.constrain_unseq(x) is x
    assert not actx.active()
    assert mine == seen
