"""Parity of the port's Pareto/co-design search (`repro_torch.core.search`,
the fronts and searches; the refinement engines are held to the reference
in `tests/test_torch_refine.py`) with the JAX package's on the CPU, the
port's own streaming contracts, `frontier_configs` and
`fabric.fabrics_from_front` on a co-design front, and
`benchmarks/torch_pareto_bench.py`'s three search sections against the
reference functions on the same grids (its refine sections run too, and
their checks must pass).

Tolerances: masks, front indices and sizes exactly; front points at rtol
1e-12, atol 0 against the reference (the port's sweep equals the
reference's at that tolerance, not bit for bit), and bit for bit between
the port's own streaming and monolithic paths.  Clouds and grids are those
of `tests/test_search.py`, at its sizes.
"""

import jax
import jax.experimental
import numpy as np
import pytest

# `repro.core.power` imports `jax.experimental.enable_x64`; newer jax only
# has `jax.enable_x64`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from repro.core import faults as JF  # noqa: E402
from repro.core import search as JS  # noqa: E402
from repro.core import sweep as JSW  # noqa: E402
from repro.core.accelerator import ChipletSpec as JChipletSpec  # noqa: E402
from repro.core.fabric import fabrics_from_front as j_fabrics_from_front  # noqa: E402
from repro.core.power import Traffic as JTraffic  # noqa: E402
from repro.core.workloads import CNN_WORKLOADS as JCNN  # noqa: E402

from repro_torch.core import faults as F  # noqa: E402
from repro_torch.core import search as S  # noqa: E402
from repro_torch.core import sweep as SW  # noqa: E402
from repro_torch.core.accelerator import ChipletSpec  # noqa: E402
from repro_torch.core.fabric import fabrics_from_front  # noqa: E402
from repro_torch.core.power import Traffic  # noqa: E402
from repro_torch.core.workloads import CNN_WORKLOADS  # noqa: E402

RTOL = 1e-12
CPU = "cpu"
TRAFFIC = Traffic(bytes_read=2e8, bytes_written=7e7, n_transfers=320)
JTRAFFIC = JTraffic(bytes_read=2e8, bytes_written=7e7, n_transfers=320)
GRID_AXES = dict(n_gateways=(8, 16, 32, 64), n_lambda=(4, 8, 16),
                 mem_bw_bytes_per_s=(50e9, 100e9, 200e9))


def _mask_all(pts):
    """The port's mask, and the reference's jitted and brute-force masks."""
    return S.pareto_mask(pts, device=CPU), JS.pareto_mask(pts), JS.pareto_mask_reference(pts)


def _same_front(got, want, ctx, rtol=RTOL):
    assert got.objectives == want.objectives, ctx
    np.testing.assert_array_equal(got.indices, want.indices, err_msg=ctx)
    assert got.indices.dtype == np.int64
    np.testing.assert_allclose(got.points, want.points, rtol=rtol, atol=0, err_msg=ctx)


def _bitwise(a, b, ctx):
    np.testing.assert_array_equal(a.indices, b.indices, err_msg=ctx)
    np.testing.assert_array_equal(a.points, b.points, err_msg=ctx)


# ---------------------------------------------------------------------------
# pareto_mask against both of the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("n", [1, 2, 3, 17, 400, 5000])
def test_pareto_mask_matches_reference_random(m, n):
    rng = np.random.default_rng(n * 10 + m)
    pts = rng.normal(size=(n, m))
    got, jit, brute = _mask_all(pts)
    assert got.dtype == bool and got.shape == (n,)
    np.testing.assert_array_equal(got, brute)
    np.testing.assert_array_equal(got, jit)


@pytest.mark.parametrize("m", [2, 3])
def test_pareto_mask_matches_reference_ties_and_duplicates(m):
    rng = np.random.default_rng(7)
    # coarse integer grid => many per-objective ties and exact duplicates
    pts = rng.integers(0, 5, size=(600, m)).astype(float)
    got, jit, brute = _mask_all(pts)
    np.testing.assert_array_equal(got, brute)
    np.testing.assert_array_equal(got, jit)
    dup = np.concatenate([pts, pts[:25]], axis=0)
    got2, jit2, brute2 = _mask_all(dup)
    np.testing.assert_array_equal(got2[600:], got2[:25])  # copies share a verdict
    np.testing.assert_array_equal(got2, brute2)
    np.testing.assert_array_equal(got2, jit2)


@pytest.mark.parametrize("m", [2, 3])
def test_pareto_mask_fold_above_one_block_with_duplicates(m):
    """A cloud of two blocks and a ragged third (the fold against the
    running front) with a front of hundreds of points: half the points on
    the plane sum = 40 (mutually non-dominated, many duplicates), half
    above it; then copies of front points and +inf rows.  The oracle is
    the reference's jitted mask, which its own tests hold equal to the
    brute force (too slow here at this size)."""
    rng = np.random.default_rng(11 + m)
    n = 2 * S._FRONT_BLOCK + 5
    pts = rng.integers(0, 20, size=(n, m)).astype(float)
    plane = rng.random(n) < 0.5
    pts[plane, -1] = 40.0 - pts[plane, :-1].sum(1)
    pts[~plane, -1] = 41.0 + pts[~plane, -1]
    pts = np.concatenate([pts, pts[plane][:50], np.full((3, m), np.inf)], axis=0)
    got, jit = S.pareto_mask(pts, device=CPU), JS.pareto_mask(pts)
    assert got[:n].sum() == plane.sum() > S._FRONT_BLOCK // 2
    np.testing.assert_array_equal(got, jit)
    np.testing.assert_array_equal(got[-53:-3], np.ones(50, bool))
    assert not got[-3:].any()


def test_pareto_mask_all_identical_points_all_on_front():
    pts = np.ones((37, 3))
    assert S.pareto_mask(pts, device=CPU).all() and JS.pareto_mask(pts).all()


def test_pareto_mask_rejects_bad_shapes_and_too_many_points(monkeypatch):
    for bad in (np.zeros((4, 5)), np.zeros((4,)), np.zeros((4, 1))):
        with pytest.raises(ValueError):
            S.pareto_mask(bad, device=CPU)
        with pytest.raises(ValueError):
            JS.pareto_mask(bad)
    assert S.pareto_mask(np.zeros((0, 3)), device=CPU).shape == (0,)
    monkeypatch.setattr(S, "_MAX_POINTS", 16)
    with pytest.raises(ValueError, match="ParetoReducer"):
        S.pareto_mask(np.zeros((16, 2)), device=CPU)


def test_pareto_mask_reference_is_the_references():
    pts = np.random.default_rng(2).normal(size=(300, 3))
    np.testing.assert_array_equal(S.pareto_mask_reference(pts, block=64),
                                  JS.pareto_mask_reference(pts))


def test_dominated_by_matches_reference():
    rng = np.random.default_rng(4)
    pts = rng.integers(0, 6, size=(700, 3)).astype(float)
    front_pts = pts[JS.pareto_mask_reference(pts)]
    np.testing.assert_array_equal(S._dominated_by(pts, front_pts, device=CPU),
                                  JS._dominated_by(pts, front_pts))
    assert not S._dominated_by(pts, front_pts[:0], device=CPU).any()


def test_no_card_is_refused():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        S.pareto_mask(np.zeros((3, 2)))


# ---------------------------------------------------------------------------
# fronts on real sweep metrics, merges, streaming
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topology", list(SW.DEFAULT_TOPOLOGIES))
def test_front_on_real_sweep_metrics_per_topology(topology):
    res = SW.sweep(TRAFFIC, topologies=(topology,), device=CPU, **GRID_AXES)
    jres = JSW.sweep(JTRAFFIC, topologies=(topology,), **GRID_AXES)
    front = S.pareto_front(res, device=CPU)
    _same_front(front, JS.pareto_front(jres), topology)
    pts = np.stack([res.metrics[k] for k in S.OBJECTIVES], -1)
    assert set(front.indices.tolist()) == set(np.where(S.pareto_mask_reference(pts))[0].tolist())
    assert front.objectives == S.OBJECTIVES == JS.OBJECTIVES


def test_merge_fronts_associativity_and_reference():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(900, 3))
    idx = np.arange(900)
    whole = S.merge_fronts(S.ParetoFront(S.OBJECTIVES, pts, idx), device=CPU)
    parts = [S.ParetoFront(S.OBJECTIVES, pts[s:s + 300], idx[s:s + 300]) for s in (0, 300, 600)]
    merged = S.merge_fronts(*[S.merge_fronts(p, device=CPU) for p in parts], device=CPU)
    _bitwise(whole, merged, "associativity")
    _bitwise(whole, JS.merge_fronts(JS.ParetoFront(JS.OBJECTIVES, pts, idx)), "reference")
    with pytest.raises(ValueError, match="no fronts"):
        S.merge_fronts(device=CPU)
    with pytest.raises(ValueError, match="objectives"):
        S.merge_fronts(parts[0], S.ParetoFront(("a", "b", "c"), pts[:1], idx[:1]), device=CPU)


def test_front_of_folds_like_the_reference():
    """A cloud of several `_FRONT_BLOCK`s through `_front_of`, with ties."""
    rng = np.random.default_rng(9)
    pts = rng.integers(0, 60, size=(10_000, 3)).astype(float)
    idx = rng.permutation(10_000) + 7
    _bitwise(S._front_of(pts, idx, S.OBJECTIVES, device=CPU),
             JS._front_of(pts, idx, JS.OBJECTIVES), "fold")


@pytest.mark.parametrize("chunk_size", [1, 7, 64, 10_000])
def test_chunked_matches_monolithic(chunk_size):
    """The streamed front at every chunk size (the padded last chunk
    included) is bit for bit the monolithic front."""
    mono = S.pareto_front(SW.sweep(TRAFFIC, device=CPU, **GRID_AXES), device=CPU)
    stream = S.pareto_search(TRAFFIC, chunk_size=chunk_size, device=CPU, **GRID_AXES)
    _bitwise(stream, mono, f"chunk {chunk_size}")


@pytest.mark.parametrize("materialize", ["device", "host"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_streaming_matches_monolithic_reference_and_bruteforce(materialize, prefetch):
    res = SW.sweep(TRAFFIC, device=CPU, **GRID_AXES)
    mono = S.pareto_front(res, device=CPU)
    stream = S.pareto_search(TRAFFIC, chunk_size=61, materialize=materialize,
                             prefetch=prefetch, device=CPU, **GRID_AXES)
    _bitwise(stream, mono, "stream vs mono")
    _same_front(stream, JS.pareto_search(JTRAFFIC, chunk_size=61, **GRID_AXES), "reference")
    pts = np.stack([res.metrics[k] for k in S.OBJECTIVES], -1)
    assert set(stream.indices.tolist()) == set(np.where(S.pareto_mask_reference(pts))[0].tolist())
    cfg = stream.configs(SW.grid_spec(**GRID_AXES))[0]
    assert cfg["topology"] in SW.DEFAULT_TOPOLOGIES


def test_pareto_search_per_workload_fronts():
    names = ("LeNet5", "VGG16")
    fronts = S.pareto_search([CNN_WORKLOADS[n]().traffic() for n in names], chunk_size=40,
                             device=CPU, **GRID_AXES)
    jfronts = JS.pareto_search([JCNN[n]().traffic() for n in names], chunk_size=40, **GRID_AXES)
    assert isinstance(fronts, list) and len(fronts) == 2
    for w, n in enumerate(names):
        mono = S.pareto_front(SW.sweep(CNN_WORKLOADS[n]().traffic(), device=CPU, **GRID_AXES),
                              device=CPU)
        _bitwise(fronts[w], mono, n)
        _same_front(fronts[w], jfronts[w], n)


def test_pareto_search_accepts_columns_fn():
    """The survivable front under a fault scenario: the reference's, and
    under HEALTHY the plain front bit for bit."""
    args = dict(p_lambda=0.15, p_bank=0.12, p_gateway=0.05, wpe_loss=0.2,
                drift_sigma_db=0.5, tuning_sigma=0.3)
    scen, jscen = F.FaultModel(**args).expected(), JF.FaultModel(**args).expected()
    kw = dict(topologies=("trine", "tree"), chunk_size=16, n_lambda=(4.0, 8.0))
    front = S.pareto_search(TRAFFIC, columns_fn=F.faulted_columns_fn(scen), device=CPU, **kw)
    _same_front(front, JS.pareto_search(JTRAFFIC, columns_fn=JF.faulted_columns_fn(jscen), **kw),
                "faulted")
    assert front.size >= 1
    healthy = S.pareto_search(TRAFFIC, columns_fn=F.faulted_columns_fn(F.HEALTHY), device=CPU,
                              **kw)
    _bitwise(healthy, S.pareto_search(TRAFFIC, device=CPU, **kw), "healthy")


# ---------------------------------------------------------------------------
# co-design search, frontier configs, fabrics from the front
# ---------------------------------------------------------------------------


def _mixes(C):
    return [[C(512, 32)], [C(512, 9), C(512, 49)], [C(256, 16), C(256, 64), C(128, 128)]]


def test_codesign_front_matches_bruteforce_and_reference():
    wl, jwl = CNN_WORKLOADS["LeNet5"](), JCNN["LeNet5"]()
    axes = dict(n_gateways=(16, 32), n_lambda=(4, 8))
    kw = dict(topologies=("trine", "tree", "elec"), chunk_size=5, **axes)
    front, spec = S.codesign_pareto(wl, _mixes(ChipletSpec), device=CPU, **kw)
    jfront, jspec = JS.codesign_pareto(jwl, _mixes(JChipletSpec), **kw)
    assert spec.n == jspec.n and spec.shape == jspec.shape
    _same_front(front, jfront, "codesign")
    # brute force over the port's own joint cloud
    from repro_torch.core.accelerator import evaluate_accelerator_grid
    cols, topo_id = spec.chunk_cols(0, spec.n)
    nets = SW.network_columns_device(cols, topo_id, spec.topologies, device=CPU)
    out = evaluate_accelerator_grid(wl, _mixes(ChipletSpec), nets, cols,
                                    cols["n_mem_chiplets"] * cols["mem_bw_bytes_per_s"],
                                    device=CPU)
    pts = np.stack([out[k] for k in S.ACCEL_OBJECTIVES], -1).reshape(-1, 3)
    assert set(front.indices.tolist()) == set(np.where(S.pareto_mask_reference(pts))[0].tolist())
    np.testing.assert_array_equal(front.points, pts[front.indices])
    assert out["latency_s"].shape == (3, spec.n)


@pytest.mark.parametrize("materialize,prefetch", [("host", 0), ("device", 2), ("host", 2)])
def test_codesign_front_bitwise_across_modes(materialize, prefetch):
    wl = CNN_WORKLOADS["LeNet5"]()
    kw = dict(topologies=("trine", "spacx"), n_gateways=(16, 32), n_lambda=(4, 8, 16))
    base, _ = S.codesign_pareto(wl, _mixes(ChipletSpec), chunk_size=5, materialize="device",
                                prefetch=0, device=CPU, **kw)
    got, _ = S.codesign_pareto(wl, _mixes(ChipletSpec), chunk_size=5, materialize=materialize,
                               prefetch=prefetch, device=CPU, **kw)
    _bitwise(got, base, f"{materialize}/{prefetch}")


def test_codesign_pareto_empty_grid_and_mixes_raise():
    wl = CNN_WORKLOADS["LeNet5"]()
    mixes = [[ChipletSpec(256, 9)]]
    with pytest.raises(ValueError, match="empty grid"):
        S.codesign_pareto(wl, mixes, n_gateways=(), device=CPU)
    with pytest.raises(ValueError, match="empty grid"):
        S.codesign_pareto(wl, mixes, topologies=(), device=CPU)
    with pytest.raises(ValueError, match="chiplet mix"):
        S.codesign_pareto(wl, [], device=CPU)
    with pytest.raises(ValueError, match="materialize"):
        S.codesign_pareto(wl, mixes, materialize="disk", n_gateways=(16,), device=CPU)


@pytest.fixture(scope="module")
def small_front():
    """`tests/test_fabric.py`'s small co-design front, through both packages."""
    wl, jwl = CNN_WORKLOADS["ResNet18"](), JCNN["ResNet18"]()
    kw = dict(topologies=("trine",), chunk_size=8, n_lambda=(4.0, 8.0),
              mem_bw_bytes_per_s=(50e9, 100e9))
    front, spec = S.codesign_pareto(wl, [[ChipletSpec(512, 32)], [ChipletSpec(256, 64)]],
                                    device=CPU, **kw)
    jfront, jspec = JS.codesign_pareto(jwl, [[JChipletSpec(512, 32)], [JChipletSpec(256, 64)]],
                                       **kw)
    return front, spec, [[ChipletSpec(512, 32)], [ChipletSpec(256, 64)]], jfront, jspec


def test_frontier_configs_mix_aware(small_front):
    front, spec, mixes, jfront, jspec = small_front
    _same_front(front, jfront, "small front")
    cfgs = S.frontier_configs(front, spec, mixes)
    jcfgs = JS.frontier_configs(jfront, jspec,
                                [[JChipletSpec(512, 32)], [JChipletSpec(256, 64)]])
    assert len(cfgs) == front.size
    assert all("chiplets" in c and "topology" in c for c in cfgs)
    for c, jc in zip(cfgs, jcfgs):
        assert {k: v for k, v in c.items() if k != "chiplets"} == \
            {k: v for k, v in jc.items() if k != "chiplets"}
        assert [(x.n_units, x.vector_size) for x in c["chiplets"]] == \
            [(x.n_units, x.vector_size) for x in jc["chiplets"]]
    for i in front.indices:
        assert S.codesign_config_at(spec, mixes, int(i))["mix"] == int(i) // spec.n
    plain = S.frontier_configs(S.ParetoFront(front.objectives, front.points[:1],
                                             front.indices[:1] % spec.n), spec)
    assert all("chiplets" not in c for c in plain)


def test_fabrics_from_front_dedup_and_traceability(small_front):
    front, spec, mixes, jfront, jspec = small_front
    fabs = fabrics_from_front(front, spec, mixes=mixes)
    jfabs = j_fabrics_from_front(jfront, jspec,
                                 mixes=[[JChipletSpec(512, 32)], [JChipletSpec(256, 64)]])
    assert fabs and [f.name for f in fabs] == [f.name for f in jfabs]
    idx = {int(i) for i in front.indices}
    for f, jf in zip(fabs, jfabs):
        topo, at = f.name.removeprefix("pareto:").split("@")
        assert topo == "trine" and int(at) in idx
        assert f.source == jf.source
        for k in ("cross_pod_bw_bytes_per_s", "intra_pod_bw_bytes_per_s", "link_latency_s",
                  "energy_per_bit_j"):
            np.testing.assert_allclose(getattr(f, k), getattr(jf, k), rtol=RTOL, atol=0)
    keys = [tuple(sorted(f.source.items())) for f in fabs]
    assert len(keys) == len(set(keys))
    assert len(fabs) <= spec.n
    assert len(fabrics_from_front(front, spec, mixes=mixes, max_fabrics=1)) == 1
    named = fabrics_from_front(front, spec, mixes=mixes, prefix="what_if")
    assert all(f.name.startswith("what_if:trine@") for f in named)


# ---------------------------------------------------------------------------
# benchmarks/torch_pareto_bench.py: its three sections against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pareto_bench_out():
    import benchmarks.torch_pareto_bench as port
    return port.run(csv=False, smoke=True, device=CPU)


def test_torch_pareto_bench_fronts_match_reference(pareto_bench_out):
    import benchmarks.pareto_bench as ref
    out = pareto_bench_out
    assert out["smoke"] is True
    assert "sections_left_out" not in out
    assert set(out["required_checks"]) <= set(out["checks"])
    assert {"refined_front", "trust_region_front", "refine"} <= set(out)
    for k in ("refinement_improves", "refined_front_dominates_seed",
              "trust_region_front_dominates_first_order",
              "trust_region_rescore_bit_identical"):
        assert out["checks"][k] and k in out["required_checks"], k
    for k in ("net_front_streaming_equals_monolithic", "net_front_matches_bruteforce",
              "codesign_front_streaming_equals_monolithic", "codesign_front_matches_bruteforce",
              "pipeline_modes_bit_identical"):
        assert out["checks"][k], k
    # the reference functions on the same grids
    wl = JCNN["ResNet18"]()
    net = JS.pareto_search(wl.traffic(), topologies=ref.TOPOLOGIES, **ref.SMOKE_NET_AXES)
    assert out["network"]["n_configs"] == JSW.grid_spec(ref.TOPOLOGIES, **ref.SMOKE_NET_AXES).n
    assert out["network"]["front_size"] == net.size
    np.testing.assert_array_equal(out["network"]["front_indices"], net.indices)
    assert out["network"]["best_config"] == net.configs(
        JSW.grid_spec(ref.TOPOLOGIES, **ref.SMOKE_NET_AXES))[0]
    cd, _ = JS.codesign_pareto(wl, ref._mix_library(True), topologies=ref.TOPOLOGIES,
                               **ref.SMOKE_NET_AXES)
    assert out["codesign"]["n_joint_points"] == \
        JSW.grid_spec(ref.TOPOLOGIES, **ref.SMOKE_NET_AXES).n * len(ref._mix_library(True))
    assert out["codesign"]["front_size"] == cd.size
    np.testing.assert_array_equal(out["codesign"]["front_indices"], cd.indices)
    jbest = JSW.sweep_chunked(wl.traffic(), JSW.MinReducer("energy_j"),
                              topologies=ref.TOPOLOGIES, **ref.SMOKE_NET_AXES)
    assert out["pipeline"]["best_index"] == jbest["index"]
    np.testing.assert_allclose(out["pipeline"]["best_energy_j"], jbest["value"], rtol=RTOL,
                               atol=0)


def test_torch_pareto_bench_checks_and_artifact(pareto_bench_out):
    import json
    import benchmarks.torch_pareto_bench as port
    out = pareto_bench_out
    smoke_exempt = ("codesign_grid_at_least_1e6", "refined_improves_a_seed",
                    "pipeline_grid_at_least_1e6", "pipelined_speedup_at_least_1p2")
    assert out["required_checks"] == [k for k in out["checks"] if k not in smoke_exempt]
    saved = json.loads((port.ARTIFACTS / "torch_pareto_bench.json").read_text())
    assert saved["checks"] == out["checks"]
    assert out["pass"], {k: out["checks"][k] for k in out["required_checks"]}
    assert out["codesign"]["n_mixes"] == 3 and out["codesign"]["front_size"] >= 1
