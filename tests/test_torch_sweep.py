"""Parity of the port's sweep engine and fault layer (`repro_torch.core.sweep`,
`repro_torch.core.faults`) with the JAX package's on the CPU, the port's own
streaming contracts, and the three `benchmarks/torch_*` scripts against their
reference counterparts.

Tolerances: float64 metrics at rtol 1e-12, atol 0 against the reference;
discrete network fields and argmin indices exactly; the port's batched
engine against its own scalar dataclass path at the reference's RTOL 1e-4
(`tests/test_sweep.py`); and bit for bit wherever the reference promises
bit-identity (decode vs `chunk_cols`, monolithic vs chunked, host vs device
materialization, every prefetch depth, faulted-healthy vs plain).
"""

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

# `repro.core.power` imports `jax.experimental.enable_x64`; newer jax only
# has `jax.enable_x64`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from repro.core import faults as JF  # noqa: E402
from repro.core import sweep as JS  # noqa: E402
from repro.core.power import Traffic as JTraffic  # noqa: E402
from repro.core.workloads import CNN_WORKLOADS as JCNN  # noqa: E402

from repro_torch.core import faults as F  # noqa: E402
from repro_torch.core import sweep as S  # noqa: E402
from repro_torch.core.power import Traffic  # noqa: E402
from repro_torch.core.topology import MODEL_FIELDS, NetworkParams  # noqa: E402
from repro_torch.core.workloads import CNN_WORKLOADS  # noqa: E402
from repro_torch.core.xp import TorchNS  # noqa: E402
from repro_torch.env import prefetch_depth  # noqa: E402

RTOL = 1e-12
SCALAR_RTOL = 1e-4
CPU = "cpu"
DISCRETE = ("n_wavelengths", "n_mr", "n_mzi", "n_stages", "n_laser_banks",
            "is_electrical", "n_routers")

T = Traffic(bytes_read=2e9, bytes_written=1e9, n_transfers=128)
JT = JTraffic(bytes_read=2e9, bytes_written=1e9, n_transfers=128)
# 5 topologies x 3 x 2 x 2 = 60 rows; chunk_size=7 leaves a 4-row padded tail
AXES = dict(n_gateways=(16.0, 32.0, 64.0), n_lambda=(4.0, 8.0),
            mem_bw_bytes_per_s=(50e9, 100e9))
CHUNK = 7
GRID_AXES = dict(n_gateways=(8, 16, 32, 64), n_lambda=(4, 8, 16),
                 mem_bw_bytes_per_s=(50e9, 100e9, 200e9))

MODEL_ARGS = dict(p_lambda=0.15, p_bank=0.12, p_gateway=0.05, wpe_loss=0.2,
                  drift_sigma_db=0.5, tuning_sigma=0.3)
MODEL, JMODEL = F.FaultModel(**MODEL_ARGS), JF.FaultModel(**MODEL_ARGS)
ALL = ("trine", "tree", "spacx", "sprint", "elec")


def _close(got, want, what, rtol=RTOL):
    got = np.asarray(got)
    assert got.dtype == np.float64, what
    if what.split("/")[-1] in DISCRETE:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=what)


def _same(a, b, ctx):
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{ctx}: {k}")


def _scen(scenario):
    """The reference's FaultScenario with the same fields."""
    return JF.FaultScenario(**{f.name: getattr(scenario, f.name)
                               for f in dataclasses.fields(scenario)})


class _Collect(S.ChunkReducer):
    """Concatenates every chunk's metrics — the reducer-state fingerprint."""

    def init(self, spec):
        return []

    def step(self, carry, chunk):
        assert all(isinstance(v, np.ndarray) for v in chunk.metrics.values())
        assert all(isinstance(v, np.ndarray) for v in chunk.nets.values())
        carry.append({k: np.array(v) for k, v in chunk.metrics.items()})
        return carry

    def finish(self, carry, spec):
        return {k: np.concatenate([c[k] for c in carry], axis=-1)
                for k in carry[0]}


class _JCollect(JS.ChunkReducer):
    init = _Collect.init
    finish = _Collect.finish

    def step(self, carry, chunk):
        carry.append({k: np.array(v) for k, v in chunk.metrics.items()})
        return carry


# ---------------------------------------------------------------------------
# eager half: grids, network columns, evaluation, sweep
# ---------------------------------------------------------------------------


def test_grid_and_spec_match_reference():
    axes = dict(AXES, **{"mzi.insertion_loss_db": (0.5, 1.0)}, n_subnetworks=(0, 4))
    got, want = S.build_grid(ALL, **axes), JS.build_grid(ALL, **axes)
    assert got.shape == want.shape and got.axes == want.axes
    np.testing.assert_array_equal(got.topo_id, want.topo_id)
    _same(got.cols, want.cols, "cols")
    spec, jspec = S.grid_spec(ALL, **axes), JS.grid_spec(ALL, **axes)
    assert spec == S.GridSpec(**{f.name: getattr(jspec, f.name)
                                for f in dataclasses.fields(jspec)})
    for i in (0, 17, spec.n - 1):
        assert spec.config_at(i) == jspec.config_at(i)
    assert S.INTEGER_AXES == JS.INTEGER_AXES and S.METRIC_FIELDS == JS.METRIC_FIELDS


def test_build_grid_rejects_unknown_axis_and_topology():
    with pytest.raises(KeyError):
        S.build_grid(("trine",), not_a_field=(1, 2))
    with pytest.raises(KeyError):
        S.build_grid(("warp-drive",))


@pytest.mark.parametrize("topologies", [ALL, ("spacx", "trine"), ("elec",)])
def test_network_columns_on_device_match_reference(topologies):
    axes = dict(GRID_AXES, interposer_side_cm=(1.0, 3.5),
                **{"mzi.insertion_loss_db": (0.25, 1.0)})
    grid = S.build_grid(topologies, **axes)
    got = S.network_columns(grid, device=CPU)
    want = JS.network_columns(JS.build_grid(topologies, **axes))
    for f in MODEL_FIELDS:
        _close(got[f], want[f], f)
    dev = JS.network_columns_device(grid.cols, grid.topo_id, topologies)
    got_dev = S.network_columns_device(grid.cols, grid.topo_id, topologies, device=CPU)
    for f in MODEL_FIELDS:
        _close(got_dev[f], dev[f], f)


def test_spacx_rejects_subcluster_gateway_counts():
    with pytest.raises(ValueError):
        S.sweep(T, topologies=("spacx",), n_gateways=(4,), device=CPU)
    with pytest.raises(ValueError):
        S.network_columns(S.build_grid(("spacx", "tree"), n_gateways=(4, 8)), device=CPU)
    with pytest.raises(ValueError):
        S.sweep_chunked(T, _Collect(), topologies=("spacx",), n_gateways=(4.0,),
                        n_lambda=(8.0,), device=CPU)


def test_evaluate_columns_and_traffic_broadcasting_match():
    grid = S.build_grid(("sprint", "tree", "trine", "elec"), n_lambda=(4, 8))
    nets = S.network_columns(grid, device=CPU)
    names = ("LeNet5", "ResNet18", "VGG16")
    traffics = [CNN_WORKLOADS[n]().traffic() for n in names]
    bits = np.asarray([[t.total_bits] for t in traffics])
    xfers = np.asarray([[t.n_transfers] for t in traffics])
    both = S.evaluate_columns(nets, grid.cols, bits, xfers, device=CPU)
    want = JS.evaluate_columns(nets, grid.cols, bits, xfers)
    assert both["latency_s"].shape == (3, grid.n)
    for k in S.METRIC_FIELDS:
        _close(both[k], want[k], k)
    for wi, t in enumerate(traffics):
        one = S.evaluate_columns(nets, grid.cols, t.total_bits, t.n_transfers,
                                 active_fraction=0.5, device=CPU)
        ref = JS.evaluate_columns(nets, grid.cols, t.total_bits, t.n_transfers,
                                  active_fraction=0.5)
        for k in S.METRIC_FIELDS:
            _close(one[k], ref[k], k)


def _sweep_pair(topologies, frac=1.0, **axes):
    got = S.sweep(T, topologies=topologies, active_fraction=frac, device=CPU, **axes)
    want = JS.sweep(JT, topologies=topologies, active_fraction=frac, **axes)
    for k in S.METRIC_FIELDS:
        _close(got.metrics[k], want.metrics[k], k)
    for f in MODEL_FIELDS:
        np.testing.assert_array_equal(got.nets[f], want.nets[f], err_msg=f)
    ref = S.sweep_scalar_reference(T, topologies=topologies, active_fraction=frac, **axes)
    jref = JS.sweep_scalar_reference(JT, topologies=topologies, active_fraction=frac,
                                     **axes)
    for k in S.METRIC_FIELDS:
        np.testing.assert_array_equal(ref[k], jref[k], err_msg=k)
        np.testing.assert_allclose(got.metrics[k], ref[k], rtol=SCALAR_RTOL, atol=0,
                                   err_msg=k)
    return got


@pytest.mark.parametrize("topology", list(S.DEFAULT_TOPOLOGIES))
def test_sweep_matches_per_topology(topology):
    res = _sweep_pair((topology,), **GRID_AXES)
    assert res.grid.n == 36


def test_sweep_matches_device_axes():
    _sweep_pair(("tree", "trine"), **{"mzi.insertion_loss_db": (0.5, 1.0, 2.0),
                                      "mr.tuning_power_w": (137e-6, 275e-6, 550e-6)})


def test_sweep_matches_subnetwork_override():
    _sweep_pair(("trine",), n_subnetworks=(1, 2, 4, 8, 16, 32))


@pytest.mark.parametrize("frac", [0.4, 0.75, 1.0])
def test_sweep_matches_active_fraction(frac):
    _sweep_pair(("trine", "sprint"), frac=frac, n_lambda=(4, 8, 16))


def test_model_at_and_row_reconstruction():
    res = S.sweep(T, topologies=("tree", "trine"), device=CPU)
    from repro_torch.core.topology import trine_network, tree_network
    p = NetworkParams()
    assert res.model_at(0) == tree_network(p)
    assert res.model_at(1) == trine_network(p)
    i, cfg = res.best("energy_j")
    assert cfg["topology"] in ("tree", "trine")
    grid = S.build_grid(("trine",), n_gateways=(16, 64),
                        **{"mzi.insertion_loss_db": (1.0, 2.0)})
    p = grid.row_params(3)
    assert isinstance(p.n_gateways, int) and p.n_gateways == 64
    assert grid.row_devices(3).mzi.insertion_loss_db == 2.0
    assert grid.row_devices(3).mr == grid.row_devices(0).mr


# ---------------------------------------------------------------------------
# streaming half: decode, modes x depths, reducers
# ---------------------------------------------------------------------------


def test_device_decode_matches_chunk_cols_exactly():
    spec = S.grid_spec(("tree", "trine", "elec"), **AXES)
    tables = {k: torch.tensor(v, dtype=torch.float64) for k, v in spec.axes.items()}
    base = {k: torch.tensor(v, dtype=torch.float64) for k, v in spec.base.items()}
    for start in range(0, spec.n, CHUNK):
        stop = min(start + CHUNK, spec.n)
        cols_d, topo_d = S._decode(spec, CHUNK, tables, base, start, torch.device(CPU))
        cols_h, topo_h = spec.chunk_cols(start, stop)
        valid = stop - start
        np.testing.assert_array_equal(topo_d.numpy()[:valid], topo_h)
        for k, v in cols_h.items():
            np.testing.assert_array_equal(cols_d[k].numpy()[:valid], v, err_msg=k)
        if valid < CHUNK:  # padding clamps to the final row (repeat-last-row)
            for k in cols_h:
                assert np.all(cols_d[k].numpy()[valid:] == cols_h[k][-1])


@pytest.mark.parametrize("materialize", ["device", "host"])
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_network_sweep_bitwise_across_modes_and_depths(materialize, depth):
    mono = S.sweep(T, device=CPU, **AXES)
    out = S.sweep_chunked(T, _Collect(), chunk_size=CHUNK, materialize=materialize,
                          prefetch=depth, device=CPU, **AXES)
    _same(out, mono.metrics, f"{materialize}/depth={depth}")
    best = S.sweep_chunked(T, S.MinReducer("energy_j"), chunk_size=CHUNK,
                           materialize=materialize, prefetch=depth, device=CPU, **AXES)
    i, _ = mono.best("energy_j")
    assert best["index"] == i
    assert best["value"] == mono.metrics["energy_j"][i]


def test_streaming_matches_reference_stream():
    traffics = [CNN_WORKLOADS[n]().traffic() for n in ("LeNet5", "VGG16", "ResNet18")]
    jtraffics = [JCNN[n]().traffic() for n in ("LeNet5", "VGG16", "ResNet18")]
    got = S.sweep_chunked(traffics, _Collect(), chunk_size=CHUNK, device=CPU, **AXES)
    want = JS.sweep_chunked(jtraffics, _JCollect(), chunk_size=CHUNK, **AXES)
    for k in S.METRIC_FIELDS:
        _close(got[k], want[k], k)
    best = S.sweep_chunked(traffics, S.MinReducer("latency_s"), chunk_size=CHUNK,
                           device=CPU, **AXES)
    jbest = JS.sweep_chunked(jtraffics, JS.MinReducer("latency_s"), chunk_size=CHUNK,
                             **AXES)
    np.testing.assert_array_equal(best["index"], jbest["index"])
    np.testing.assert_allclose(best["value"], jbest["value"], rtol=RTOL, atol=0)
    assert best["config"] == jbest["config"]


def test_multi_workload_traffic_bitwise_across_depths():
    traffics = [T, Traffic(bytes_read=5e8, bytes_written=5e8, n_transfers=32)]
    ref = S.sweep_chunked(traffics, _Collect(), chunk_size=CHUNK, prefetch=0,
                          device=CPU, **AXES)
    assert ref["latency_s"].shape[0] == 2
    for depth in (1, 2):
        for mat in ("device", "host"):
            out = S.sweep_chunked(traffics, _Collect(), chunk_size=CHUNK, materialize=mat,
                                  prefetch=depth, device=CPU, **AXES)
            _same(out, ref, f"{mat}/depth={depth}")


def test_min_reducer_ties_go_to_lowest_index():
    """Equal minima in two chunks: the earlier flat index wins, as
    `np.argmin` over the whole grid gives."""
    spec = S.grid_spec(("tree",), n_lambda=(4.0, 8.0, 16.0, 32.0))
    red = S.MinReducer("energy_j")

    def chunk(start, vals):
        m = np.asarray(vals, np.float64)
        return S.SweepChunk(spec=spec, start=start, stop=start + m.shape[-1],
                            topo_id=np.zeros(m.shape[-1], np.int64), nets={},
                            metrics={"energy_j": m})

    carry = red.step(None, chunk(0, [[3.0, 1.0], [2.0, 5.0]]))
    carry = red.step(carry, chunk(2, [[1.0, 1.0], [0.5, 2.0]]))
    out = red.finish(carry, spec)
    np.testing.assert_array_equal(out["index"], [1, 2])
    full = np.array([[3.0, 1.0, 1.0, 1.0], [2.0, 5.0, 0.5, 2.0]])
    np.testing.assert_array_equal(out["index"], np.argmin(full, axis=-1))


def test_legacy_columns_fn_still_runs_on_host_columns():
    scen = MODEL.expected()
    hook = F.faulted_columns_fn(scen)
    ref = S.sweep_chunked(T, _Collect(), chunk_size=CHUNK, columns_fn=hook, prefetch=0,
                          device=CPU, **AXES)
    seen = []

    def legacy(cols, topo_id, topologies):
        seen.append(int(topo_id.size))
        return hook(cols, topo_id, topologies)

    out = S.sweep_chunked(T, _Collect(), chunk_size=CHUNK, columns_fn=legacy, prefetch=2,
                          device=CPU, **AXES)
    assert seen and all(s == CHUNK for s in seen)  # host columns, padded
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-7)
    want = JS.sweep_chunked(JT, _JCollect(), chunk_size=CHUNK,
                            columns_fn=JF.faulted_columns_fn(_scen(scen)),
                            prefetch=0, **AXES)
    for k in ref:
        _close(ref[k], want[k], k)


def test_prefetch_depth_env_parsing(monkeypatch):
    monkeypatch.delenv("REPRO_PREFETCH", raising=False)
    assert prefetch_depth() == 2
    monkeypatch.setenv("REPRO_PREFETCH", "0")
    assert prefetch_depth() == 0
    monkeypatch.setenv("REPRO_PREFETCH", "-3")
    assert prefetch_depth() == 0
    monkeypatch.setenv("REPRO_PREFETCH", "banana")
    assert prefetch_depth() == 2


def test_repro_prefetch_env_changes_schedule_not_results(monkeypatch):
    ref = S.sweep_chunked(T, _Collect(), chunk_size=CHUNK, prefetch=0, device=CPU, **AXES)
    monkeypatch.setenv("REPRO_PREFETCH", "3")
    out = S.sweep_chunked(T, _Collect(), chunk_size=CHUNK, device=CPU, **AXES)
    _same(out, ref, "env-depth")


def test_bad_materialize_and_no_card_rejected():
    with pytest.raises(ValueError, match="materialize"):
        S.sweep_chunked(T, _Collect(), materialize="gpu", device=CPU, **AXES)
    if not torch.cuda.is_available():
        for call in (lambda: S.sweep(T, **AXES),
                     lambda: S.sweep_chunked(T, _Collect(), **AXES),
                     lambda: S.network_columns(S.build_grid(("tree",))),
                     lambda: S.evaluate_columns({}, {}, 1.0, 1.0),
                     lambda: F.evaluate_degraded(T, F.HEALTHY, "tree"),
                     lambda: F.availability_search(T, MODEL.sample(2, rng=0), **AXES)):
            with pytest.raises(RuntimeError, match="cuda"):
                call()


def test_shard_forces_host_materialization_with_same_results():
    ref = S.sweep_chunked(T, _Collect(), chunk_size=CHUNK, device=CPU, **AXES)
    out = S.sweep_chunked(T, _Collect(), chunk_size=CHUNK, shard=True,
                          materialize="device", device=CPU, **AXES)
    _same(out, ref, "shard")


def test_engine_runs_float64_even_in_f32_session():
    ref = S.sweep_chunked(T, _Collect(), chunk_size=CHUNK, device=CPU, **AXES)
    mono_ref = S.sweep(T, device=CPU, **AXES)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    try:
        assert torch.tensor(1.0).dtype == torch.float32
        out = S.sweep_chunked(T, _Collect(), chunk_size=CHUNK, device=CPU, **AXES)
        mono = S.sweep(T, device=CPU, **AXES)
        cols = S.network_columns(S.build_grid(ALL, **AXES), device=CPU)
        deg = F.evaluate_degraded(T, MODEL.sample(3, rng=1), "trine", device=CPU)
    finally:
        torch.set_default_dtype(old)
    assert out["energy_j"].dtype == np.float64 and mono.metrics["energy_j"].dtype == np.float64
    assert all(v.dtype == np.float64 for v in cols.values())
    assert deg["energy_j"].dtype == np.float64
    _same(out, ref, "f32 session")
    _same(mono.metrics, mono_ref.metrics, "f32 session mono")


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------


def test_fault_model_draws_and_scenarios_match():
    s, js = MODEL.sample(64, rng=5), JMODEL.sample(64, rng=5)
    for f in F._SCENARIO_FIELDS:
        np.testing.assert_array_equal(getattr(s, f), getattr(js, f), err_msg=f)
    assert F._SCENARIO_FIELDS == JF._SCENARIO_FIELDS
    for sev in (0.0, 0.5, 2.0):
        e, je = MODEL.scale(sev).expected(), JMODEL.scale(sev).expected()
        assert dataclasses.asdict(e) == dataclasses.asdict(je)
    assert s.n_scenarios == 64 and s.batch_shape() == (64, 1)
    assert F.HEALTHY.is_healthy() and not MODEL.expected().is_healthy()


def test_degradation_algebra_matches_on_host_and_device():
    r = np.random.default_rng(6)
    n = 256
    cols = S.build_grid(ALL, **AXES).cols
    cols = {k: np.resize(v, n) * (r.uniform(0.8, 1.2, n) if "." in k else 1.0)
            for k, v in cols.items()}
    topo_id = r.integers(0, len(ALL), n)
    for scen in (MODEL.expected(), MODEL.sample(5, rng=2), F.HEALTHY):
        got, gd = F.degraded_network_columns(cols, topo_id, ALL, scen)
        want, wd = JF.degraded_network_columns(cols, topo_id, ALL, _scen(scen))
        for f in MODEL_FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        _same(gd, wd, "degraded device columns")
        xp = TorchNS(CPU)
        tcols = {k: torch.from_numpy(v) for k, v in cols.items()}
        tscen = F.FaultScenario(**{f: xp.asarray(getattr(scen, f)) for f in F._SCENARIO_FIELDS})
        dcols = F.degrade_device_columns(tcols, tscen, xp)
        nets = S._select(dcols, torch.from_numpy(topo_id), ALL, xp, tscen,
                         tcols["n_gateways"])
        shape = np.broadcast_shapes(scen.batch_shape(), (n,))
        for f in MODEL_FIELDS:
            _close(torch.broadcast_to(nets[f], shape).numpy(), want[f], f)


@pytest.mark.parametrize("topo", ALL)
def test_evaluate_degraded_matches(topo):
    tr = Traffic(bytes_read=1 << 30, bytes_written=1 << 28, n_transfers=64)
    jtr = JTraffic(bytes_read=1 << 30, bytes_written=1 << 28, n_transfers=64)
    for scen in (F.HEALTHY, MODEL.expected(), MODEL.sample(16, rng=0),
                 F.FaultScenario(failed_laser_banks=1.0)):
        got = F.evaluate_degraded(tr, scen, topo, device=CPU)
        want = JF.evaluate_degraded(jtr, _scen(scen), topo)
        for k in S.METRIC_FIELDS:
            assert got[k].shape == want[k].shape
            _close(got[k], want[k], f"{topo}/{k}")


@pytest.mark.parametrize("topo", ALL)
def test_metrics_monotone_in_severity(topo):
    tr = Traffic(bytes_read=1 << 30, bytes_written=1 << 28, n_transfers=64)
    prev = None
    for s in (0.0, 0.25, 0.5, 1.0, 2.0, 4.0):
        m = F.evaluate_degraded(tr, MODEL.scale(s).expected(), topo, device=CPU)
        lat, edp = float(m["latency_s"][0]), float(m["latency_s"][0] * m["energy_j"][0])
        if prev is not None:
            assert lat >= prev[0] * (1 - 1e-9), (topo, s)
            assert edp >= prev[1] * (1 - 1e-9), (topo, s)
        prev = (lat, edp)


def test_single_bank_and_gateway_blast_radius():
    tr = Traffic(bytes_read=1 << 30, bytes_written=1 << 28, n_transfers=64)
    one_bank, one_gw = F.FaultScenario(failed_laser_banks=1.0), F.FaultScenario(failed_gateways=1.0)
    assert np.isinf(F.evaluate_degraded(tr, one_bank, "tree", device=CPU)["latency_s"][0])
    h = F.evaluate_degraded(tr, F.HEALTHY, "trine", device=CPU)["latency_s"][0]
    d = F.evaluate_degraded(tr, one_bank, "trine", device=CPU)["latency_s"][0]
    assert 1.0 < d / h <= 8.0 / 7.0 + 1e-9
    np.testing.assert_allclose(F.evaluate_degraded(tr, one_gw, "trine", device=CPU)["latency_s"],
                               F.evaluate_degraded(tr, one_bank, "trine", device=CPU)["latency_s"],
                               rtol=1e-9)


def test_faulted_healthy_is_bitwise_plain_every_mode():
    plain = S.sweep(T, device=CPU, **AXES)
    for depth in (0, 2):
        for mat in ("device", "host"):
            out = S.sweep_chunked(T, _Collect(), chunk_size=CHUNK,
                                  columns_fn=F.faulted_columns_fn(F.HEALTHY),
                                  materialize=mat, prefetch=depth, device=CPU, **AXES)
            _same(out, plain.metrics, f"{mat}/depth={depth}")


def test_faulted_batched_scenarios_bitwise_and_match_reference():
    scen = MODEL.sample(6, rng=7)
    ref = None
    for depth in (0, 1, 2):
        for mat in ("device", "host"):
            out = S.sweep_chunked(T, _Collect(), chunk_size=CHUNK,
                                  columns_fn=F.faulted_columns_fn(scen),
                                  materialize=mat, prefetch=depth, device=CPU, **AXES)
            assert out["latency_s"].shape[0] == 6
            if ref is None:
                ref = out
            else:
                _same(out, ref, f"{mat}/depth={depth}")
    want = JS.sweep_chunked(JT, _JCollect(), chunk_size=CHUNK,
                            columns_fn=JF.faulted_columns_fn(_scen(scen)), **AXES)
    for k in ref:
        _close(ref[k], want[k], k)


def test_availability_search_matches_reference_and_budget_extremes():
    scenarios = MODEL.sample(8, rng=3)
    kw = dict(topologies=("trine", "tree"), chunk_size=16,
              n_lambda=(4.0, 8.0), mem_bw_bytes_per_s=(50e9, 100e9))
    tr = Traffic(bytes_read=1 << 30, bytes_written=1 << 28, n_transfers=64)
    jtr = JTraffic(bytes_read=1 << 30, bytes_written=1 << 28, n_transfers=64)
    lenient = F.availability_search(tr, scenarios, epb_budget_j=1e3, device=CPU, **kw)
    strict = F.availability_search(tr, scenarios, epb_budget_j=0.0, device=CPU, **kw)
    mid = F.availability_search(tr, scenarios, epb_budget_j=2e-10, device=CPU, **kw)
    jmid = JF.availability_search(jtr, _scen(scenarios), epb_budget_j=2e-10, **kw)
    np.testing.assert_array_equal(mid["availability"], jmid["availability"])
    for k in ("expected_edp", "expected_epb"):
        _close(mid[k], jmid[k], k)
    assert mid["best_survivable"] == jmid["best_survivable"] or (
        mid["best_survivable"]["index"] == jmid["best_survivable"]["index"])
    assert lenient["n"] == 8 and lenient["n_scenarios"] == 8
    a = lenient["availability"]
    assert np.all((0.0 <= a) & (a <= 1.0)) and a.max() == 1.0 and a.min() < 1.0
    assert np.all(strict["availability"] == 0.0) and strict["best_survivable"] is None
    assert lenient["best_survivable"]["config"]["topology"] in ("trine", "tree")
    for mat in ("host", "device"):
        for depth in (0, 2):
            again = F.availability_search(tr, scenarios, epb_budget_j=2e-10, device=CPU,
                                          materialize=mat, prefetch=depth, **kw)
            for k in ("expected_edp", "expected_epb", "availability"):
                np.testing.assert_array_equal(again[k], mid[k], err_msg=k)


# ---------------------------------------------------------------------------
# benchmarks/torch_* against their reference scripts
# ---------------------------------------------------------------------------


def _rows_match(got, want, ctx):
    assert len(got) == len(want), ctx
    for a, b in zip(got, want):
        assert a.keys() == b.keys(), ctx
        for k in a:
            if isinstance(a[k], dict):
                assert a[k].keys() == b[k].keys()
                for kk in a[k]:
                    np.testing.assert_allclose(a[k][kk], b[k][kk], rtol=RTOL, atol=0,
                                               err_msg=f"{ctx}/{k}/{kk}")
            elif isinstance(a[k], str):
                assert a[k] == b[k], f"{ctx}/{k}"
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=0,
                                           err_msg=f"{ctx}/{k}")


def test_torch_fig4_matches_reference():
    import benchmarks.fig4_trine as ref
    import benchmarks.torch_fig4_trine as port
    got, want = port.run(csv=False, device=CPU), ref.run(csv=False)
    assert got["params"] == want["params"]
    _rows_match(got["rows"], want["rows"], "fig4")
    assert got["checks"] == want["checks"] and all(got["checks"].values())


def test_torch_fig6_matches_reference():
    import benchmarks.fig6_crosslight as ref
    import benchmarks.torch_fig6_crosslight as port
    got, want = port.run(csv=False, device=CPU), ref.run(csv=False)
    _rows_match(got["rows"], want["rows"], "fig6")
    for k in want["avg"]:
        np.testing.assert_allclose(got["avg"][k], want["avg"][k], rtol=RTOL, atol=0)
    assert got["checks"] == want["checks"] and all(got["checks"].values())


def test_torch_sweep_bench_matches_reference():
    import benchmarks.sweep_bench as ref
    import benchmarks.torch_sweep_bench as port
    got, want = port.run(csv=False, smoke=True, device=CPU), ref.run(csv=False, smoke=True)
    assert got["n_configs"] == want["n_configs"] and got["smoke"] is True
    assert got["required_checks"] == want["required_checks"]
    assert got["checks"]["grid_at_least_4096"] == want["checks"]["grid_at_least_4096"]
    for k in got["required_checks"]:
        assert got["checks"][k], (k, got)
    assert got["max_rel_err"] < 1e-12
    assert got["pass"]
