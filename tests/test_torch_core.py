"""Parity of the port's analytic engine, modules devices -> planner ->
topology -> power -> workloads -> accelerator (`repro_torch.core`), with the
JAX package's `repro.core` on the CPU: the same numpy inputs, made from a
seed, through both.

Tolerances: the scalar host path is the same numpy code on both sides and
must agree exactly; the torch path (float64 on `device="cpu"`) is held at
rtol 1e-12, atol 0 on continuous metrics and exactly on discrete fields
(stage, ring, MZI, wavelength, bank and router counts, `is_electrical`).
Gradients through the relaxed accelerator model are held at rtol 1e-10.
"""

import dataclasses

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# `repro.core.power` imports `jax.experimental.enable_x64`; newer jax only
# has `jax.enable_x64`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from repro.core import accelerator as JA  # noqa: E402
from repro.core import devices as JD  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro.core import power as JPW  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core import workloads as JW  # noqa: E402

from repro_torch.core import accelerator as A  # noqa: E402
from repro_torch.core import devices as D  # noqa: E402
from repro_torch.core import planner as P  # noqa: E402
from repro_torch.core import power as PW  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.core import workloads as W  # noqa: E402
from repro_torch.core.faults import FabricUnusableError  # noqa: E402
from repro_torch.core.xp import TorchNS  # noqa: E402

RTOL = 1e-12
GRAD_RTOL = 1e-10
CPU = "cpu"
XT = TorchNS(CPU)
DISCRETE = ("n_wavelengths", "n_mr", "n_mzi", "n_stages", "n_laser_banks",
            "is_electrical", "n_routers")
TOPOS = ("sprint", "spacx", "tree", "trine", "elec")
ACCELS = ("monolithic_crosslight", "crosslight_25d_elec", "crosslight_25d_siph")


def _rng(*seed):
    return np.random.default_rng(list(seed))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, what, rtol=RTOL):
    got, want = np.broadcast_arrays(_np(got), np.asarray(want, np.float64))
    assert got.dtype == np.float64, what
    if what.split("/")[-1] in DISCRETE:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=what)


def _rand_cols(rng, n):
    """Random network + device columns over the engine's axis vocabulary."""
    cols = {
        "n_gateways": rng.integers(8, 129, n).astype(np.float64),
        "n_mem_chiplets": rng.integers(1, 5, n).astype(np.float64),
        "mem_bw_bytes_per_s": rng.choice([25e9, 50e9, 100e9, 200e9, 400e9], n),
        "n_lambda": rng.choice([2.0, 4.0, 8.0, 16.0, 32.0], n),
        "modulation_rate_bps": rng.uniform(4e9, 25e9, n),
        "gateway_rate_hz": rng.uniform(1e9, 4e9, n),
        "gateway_width_bits": rng.choice([32.0, 64.0, 128.0], n),
        "interposer_side_cm": rng.uniform(0.5, 6.0, n),
        "n_subnetworks": rng.choice([0.0, 0.0, 1.0, 2.0, 4.0, 8.0, 16.0], n),
    }
    for k, v in JD.device_columns().items():
        cols[k] = v * rng.uniform(0.5, 1.5, n)
    return cols


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------


def test_device_library_and_columns_match():
    assert D.device_columns() == JD.device_columns()
    assert dataclasses.asdict(D.DEFAULT_DEVICES) == dataclasses.asdict(JD.DEFAULT_DEVICES)
    leaves = {"mzi.insertion_loss_db": 2.0, "mr.resolution_bits": 6.0,
              "laser.wall_plug_efficiency": 0.05}
    got = D.replace_device_leaves(D.DEFAULT_DEVICES, leaves)
    want = JD.replace_device_leaves(JD.DEFAULT_DEVICES, leaves)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert isinstance(got.mr.resolution_bits, int)


def test_db_helpers_and_laser_power_match():
    r = _rng(1)
    db = r.uniform(-40, 40, 257)
    for name in ("db_to_linear", "dbm_to_watt"):
        np.testing.assert_array_equal(getattr(D, name)(db), getattr(JD, name)(db))
    lin = r.uniform(1e-6, 1e3, 257)
    for name in ("linear_to_db", "watt_to_dbm"):
        np.testing.assert_array_equal(getattr(D, name)(lin), getattr(JD, name)(lin))
    loss, n_lam = r.uniform(0, 30, 64), r.integers(1, 256, 64)
    d = D.replace_device_leaves(D.DEFAULT_DEVICES, {"pd.sensitivity_dbm": -22.0})
    jd = JD.replace_device_leaves(JD.DEFAULT_DEVICES, {"pd.sensitivity_dbm": -22.0})
    np.testing.assert_array_equal(D.laser_electrical_power_w(loss, n_lam, d, n_banks=3),
                                  JD.laser_electrical_power_w(loss, n_lam, jd, n_banks=3))


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


def _pow2_neighbours():
    p = 2.0 ** np.arange(61)
    return np.unique(np.concatenate([p, np.nextafter(p, 0), np.nextafter(p, np.inf),
                                     p + 1, np.maximum(p - 1, 0.5)]))


@pytest.mark.parametrize("path", ["numpy", "torch"])
def test_ceil_log2_exact_at_powers_of_two_and_neighbours(path):
    v = _pow2_neighbours()
    want = JP.ceil_log2(v)
    got = P.ceil_log2(v) if path == "numpy" else P.ceil_log2(torch.from_numpy(v), XT)
    np.testing.assert_array_equal(_np(got), want)
    assert _np(got).dtype == np.float64
    # and against the reference's traced (jnp) path
    with JPW.engine_x64():
        np.testing.assert_array_equal(np.asarray(JP.ceil_log2(jnp.asarray(v), jnp)), want)
    p = 2.0 ** np.arange(61)
    np.testing.assert_array_equal(_np(P.ceil_log2(torch.from_numpy(p), XT)), np.arange(61))


@pytest.mark.parametrize("round_mode", ["paper", "cover"])
@pytest.mark.parametrize("path", ["numpy", "torch"])
def test_choose_subnetworks_arr_matches(round_mode, path):
    c = _rand_cols(_rng(2), 4096)
    args = [c[k] for k in ("n_lambda", "modulation_rate_bps", "n_mem_chiplets",
                           "mem_bw_bytes_per_s", "n_gateways")]
    want = JP.choose_subnetworks_arr(*args, round_mode=round_mode)
    if path == "numpy":
        got = P.choose_subnetworks_arr(*args, round_mode=round_mode)
    else:
        got = P.choose_subnetworks_arr(*[torch.from_numpy(a) for a in args], xp=XT,
                                       round_mode=round_mode)
    np.testing.assert_array_equal(_np(got), want)


def test_choose_subnetworks_paper_and_cover_at_defaults():
    p, jp = T.NetworkParams(), JT.NetworkParams()
    assert P.choose_subnetworks(p) == JP.choose_subnetworks(jp) == 8
    assert P.choose_subnetworks(p, round_mode="cover") == \
        JP.choose_subnetworks(jp, round_mode="cover") == 16
    with pytest.raises(ValueError, match="round_mode"):
        P.choose_subnetworks(p, round_mode="nearest")


@pytest.mark.parametrize("path", ["numpy", "torch"])
def test_plan_gateway_activation_matches(path):
    r = _rng(3)
    demand = r.uniform(0, 2e12, 2048) * (r.uniform(size=2048) > 0.1)
    maxbw = r.uniform(0, 1e12, 2048) * (r.uniform(size=2048) > 0.1)
    n = r.integers(1, 64, 2048).astype(np.float64)
    want = JP.plan_gateway_activation_arr(demand, maxbw, n)
    if path == "numpy":
        got = P.plan_gateway_activation_arr(demand, maxbw, n)
    else:
        got = P.plan_gateway_activation_arr(*map(torch.from_numpy, (demand, maxbw, n)), xp=XT)
    np.testing.assert_array_equal(_np(got), want)
    assert P.plan_gateway_activation(3e10, 1e11, 8) == JP.plan_gateway_activation(3e10, 1e11, 8)


def test_plan_collective_channels_matches_and_refuses():
    r = _rng(4)
    for _ in range(64):
        b, win, bw = r.uniform(0, 8e9), r.uniform(1e-4, 1e-1), r.uniform(1e9, 1e12)
        kw = dict(max_channels=int(r.integers(1, 65)))
        assert P.plan_collective_channels(b, win, bw, **kw) == \
            JP.plan_collective_channels(b, win, bw, **kw)

    class _Link:
        cross_pod_bw_bytes_per_s = 5e10

    assert P.plan_collective_channels(1 << 32, 0.01, fabric=_Link()) == \
        JP.plan_collective_channels(1 << 32, 0.01, fabric=_Link())
    # a preset by name resolves through `core.fabric.get_fabric`, as the
    # reference's does; an unknown name is refused as the reference refuses it
    for name in ("trine_siph", "tree_siph", "metallic_ici"):
        assert P.plan_collective_channels(1 << 30, 0.05, fabric=name, max_channels=64) == \
            JP.plan_collective_channels(1 << 30, 0.05, fabric=name, max_channels=64)
    with pytest.raises(KeyError, match="unknown fabric preset"):
        P.plan_collective_channels(1 << 30, 0.05, fabric="copper_dream")
    with pytest.raises(FabricUnusableError):
        P.plan_collective_channels(1 << 30, 0.05, link_bw_bytes_per_s=0.0)
    with pytest.raises(ValueError):
        P.plan_collective_channels(1 << 30, 0.05)


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("path", ["numpy", "torch"])
def test_topology_kernel_matches(topo, path):
    c = _rand_cols(_rng(5, TOPOS.index(topo)), 2048)
    want = JT.TOPOLOGY_ARRAYS[topo](c)
    if path == "numpy":
        got = T.TOPOLOGY_ARRAYS[topo](c)
        for f in T.MODEL_FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    else:
        got = T.TOPOLOGY_ARRAYS[topo]({k: torch.from_numpy(v) for k, v in c.items()}, XT)
        for f in T.MODEL_FIELDS:
            _close(got[f], want[f], f"{topo}/{f}")
    assert T.MODEL_FIELDS == JT.MODEL_FIELDS and T.PARAM_FIELDS == JT.PARAM_FIELDS


@pytest.mark.parametrize("n_gateways", [8, 16, 32, 48, 64])
def test_scalar_factories_match(n_gateways):
    p, jp = T.NetworkParams(n_gateways=n_gateways), JT.NetworkParams(n_gateways=n_gateways)
    for name in TOPOS:
        assert dataclasses.asdict(T.TOPOLOGIES[name](p)) == \
            dataclasses.asdict(JT.TOPOLOGIES[name](jp)), name
    for k in (1, 2, 4, 8):
        assert dataclasses.asdict(T.trine_network(p, n_subnetworks=k)) == \
            dataclasses.asdict(JT.trine_network(jp, n_subnetworks=k))
    got = T.params_columns(p, n_subnetworks=4)
    assert got == JT.params_columns(jp, n_subnetworks=4)


def test_spacx_rejects_subcluster_gateways_on_host():
    with pytest.raises(ValueError):
        T.spacx_bus(T.NetworkParams(n_gateways=4))


# ---------------------------------------------------------------------------
# power
# ---------------------------------------------------------------------------


def _traffic(r, mod):
    return mod.Traffic(bytes_read=float(r.uniform(1e5, 1e10)),
                       bytes_written=float(r.uniform(1e4, 1e9)),
                       n_transfers=int(r.integers(1, 2000)))


@pytest.mark.parametrize("frac", [0.3, 0.75, 1.0])
def test_evaluate_network_scalar_matches(frac):
    r = _rng(6, int(frac * 100))
    for name in TOPOS:
        p = T.NetworkParams(n_gateways=int(r.integers(8, 65)))
        jp = JT.NetworkParams(n_gateways=p.n_gateways)
        t = _traffic(r, PW)
        jt = JPW.Traffic(t.bytes_read, t.bytes_written, t.n_transfers)
        got = PW.evaluate_network(T.TOPOLOGIES[name](p), t, active_fraction=frac)
        want = JPW.evaluate_network(JT.TOPOLOGIES[name](jp), jt, active_fraction=frac)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name


def _eval_inputs(seed, n):
    r = _rng(7, seed)
    c = _rand_cols(r, n)
    topo = r.integers(0, len(TOPOS), n)
    nets = {f: np.zeros(n) for f in T.MODEL_FIELDS}
    for ti, name in enumerate(TOPOS):
        m = topo == ti
        sub = JT.TOPOLOGY_ARRAYS[name]({k: v[m] for k, v in c.items()})
        for f in T.MODEL_FIELDS:
            nets[f][m] = sub[f]
    dev = {k: c[k] for k in PW.EVAL_DEVICE_FIELDS}
    return r, nets, dev


@pytest.mark.parametrize("shape", ["scalar", "workloads", "fractions"])
def test_eval_network_math_matches(shape):
    r, nets, dev = _eval_inputs(["scalar", "workloads", "fractions"].index(shape), 1024)
    if shape == "scalar":
        bits, xfers, frac = np.float64(3e9), np.float64(320.0), np.float64(1.0)
    elif shape == "workloads":
        bits = r.uniform(1e6, 1e11, (6, 1))
        xfers = r.integers(16, 2000, (6, 1)).astype(np.float64)
        frac = np.float64(0.6)
    else:
        bits, xfers = np.float64(8e9), np.float64(64.0)
        frac = r.uniform(0.0, 1.2, 1024)
    with JPW.engine_x64():
        want = JPW.eval_network_math(
            {k: jnp.asarray(v) for k, v in nets.items()},
            {k: jnp.asarray(v) for k, v in dev.items()},
            jnp.asarray(bits), jnp.asarray(xfers), jnp.asarray(frac))
        want = {k: np.asarray(v) for k, v in want.items()}
    tt = {k: torch.from_numpy(v) for k, v in nets.items()}
    td = {k: torch.from_numpy(v) for k, v in dev.items()}
    got = PW.eval_network_math(tt, td, XT.asarray(bits), XT.asarray(xfers), XT.asarray(frac))
    assert tuple(got) == PW.EVAL_METRIC_FIELDS == JPW.EVAL_METRIC_FIELDS
    assert PW.EVAL_DEVICE_FIELDS == JPW.EVAL_DEVICE_FIELDS
    for k in want:
        _close(got[k], want[k], k)
    b = PW.broadcast_metrics({k: _np(v) for k, v in got.items()}, np)
    assert len({v.shape for v in b.values()}) == 1


def test_pow10_matches_libm_and_is_position_independent():
    x = _rng(8).uniform(-8.0, 8.0, 100003)
    got = _np(XT.pow10(torch.from_numpy(x)))
    # both within one ulp of the exact value, so within two of each other
    np.testing.assert_allclose(got, 10.0 ** x, rtol=2 * 2.0 ** -52, atol=0)
    # each element the same whatever its neighbours and position
    parts = np.concatenate([_np(XT.pow10(torch.from_numpy(x[i:i + 7])))
                            for i in range(0, x.size, 7)])
    np.testing.assert_array_equal(parts, got)
    e = np.arange(-60, 61, dtype=np.float64)
    np.testing.assert_array_equal(_np(XT.pow2(torch.from_numpy(e))), 2.0 ** e)
    np.testing.assert_array_equal(_np(XT.pow10(torch.arange(0.0, 22.0, dtype=torch.float64))),
                                  10.0 ** np.arange(0.0, 22.0))


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(JW.CNN_WORKLOADS))
def test_workloads_match(name):
    got, want = W.CNN_WORKLOADS[name](), JW.CNN_WORKLOADS[name]()
    assert got.name == want.name and len(got.layers) == len(want.layers)
    for a, b in zip(got.layers, want.layers):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert got.total_macs == want.total_macs
    assert dataclasses.asdict(got.traffic()) == dataclasses.asdict(want.traffic())
    assert got.traffic().total_bits == want.traffic().total_bits
    assert tuple(W.CNN_WORKLOADS) == tuple(JW.CNN_WORKLOADS)


def test_gemm_workload_matches():
    gemms = [(128, 4096, 4096), (128, 4096, 11008), (7, 3, 5)]
    got, want = W.gemm_workload("lm", gemms), JW.gemm_workload("lm", gemms)
    assert [dataclasses.asdict(x) for x in got.layers] == \
        [dataclasses.asdict(x) for x in want.layers]


# ---------------------------------------------------------------------------
# accelerator
# ---------------------------------------------------------------------------

REPORT_FIELDS = A.ACCEL_REPORT_FIELDS


@pytest.mark.parametrize("accel", ACCELS)
def test_accelerator_configs_match(accel):
    got, want = getattr(A, accel)(), getattr(JA, accel)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert REPORT_FIELDS == JA.ACCEL_REPORT_FIELDS


@pytest.mark.parametrize("accel", ACCELS)
@pytest.mark.parametrize("wl", list(JW.CNN_WORKLOADS))
def test_evaluate_accelerator_scalar_and_batch_match(accel, wl):
    a, ja = getattr(A, accel)(), getattr(JA, accel)()
    w, jw = W.CNN_WORKLOADS[wl](), JW.CNN_WORKLOADS[wl]()
    scalar = A.evaluate_accelerator(a, w)
    assert dataclasses.asdict(scalar) == dataclasses.asdict(JA.evaluate_accelerator(ja, jw))
    got = A.evaluate_accelerator_batch(a, w, device=CPU)
    want = JA.evaluate_accelerator_batch(ja, jw)
    assert got.name == want.name
    for f in REPORT_FIELDS:
        _close(getattr(got, f), getattr(want, f), f"{accel}/{wl}/{f}")
        # the batched mirror of the scalar loop, at the reference's tolerance
        assert getattr(got, f) == pytest.approx(getattr(scalar, f), rel=1e-4), f


MIXES = [
    [(512, 32)],
    [(512, 9), (512, 27), (512, 49), (512, 128)],
    [(256, 9), (0, 1), (128, 49)],          # zero-unit padding inside a mix
    [(64, 3), (1024, 64)],
]


def _mixes(mod):
    return [[mod.ChipletSpec(u, v) for u, v in m] for m in MIXES]


def _grid_inputs(seed, n):
    r, nets, dev = _eval_inputs(seed, n)
    mem_bw = r.uniform(25e9, 800e9, n)
    return r, nets, dev, mem_bw


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("wl", ["LeNet5", "MobileNetV2"])
def test_evaluate_accelerator_grid_matches(adaptive, wl):
    r, nets, dev, mem_bw = _grid_inputs(9, 48)
    kw = dict(mac_rate_hz=4e9, lambda_slot_energy_j=25e-15,
              adaptive_gateways=adaptive, transfers_per_layer=12)
    want = JA.evaluate_accelerator_grid(JW.CNN_WORKLOADS[wl](), _mixes(JA), nets, dev,
                                        mem_bw, **kw)
    got = A.evaluate_accelerator_grid(W.CNN_WORKLOADS[wl](), _mixes(A), nets, dev,
                                      mem_bw, device=CPU, **kw)
    for f in REPORT_FIELDS:
        assert got[f].shape == (len(MIXES), 48)
        _close(got[f], want[f], f"{wl}/{f}")


@pytest.mark.parametrize("frac_shape", ["ML", "MNL"])
def test_evaluate_accelerator_grid_frac_override_matches(frac_shape):
    r, nets, dev, mem_bw = _grid_inputs(10, 16)
    wl = "ResNet18"
    n_layers = len(JW.CNN_WORKLOADS[wl]().layers)
    shape = (len(MIXES), n_layers) if frac_shape == "ML" else (len(MIXES), 16, n_layers)
    frac = r.uniform(0.05, 1.0, shape)
    want = JA.evaluate_accelerator_grid(JW.CNN_WORKLOADS[wl](), _mixes(JA), nets, dev,
                                        mem_bw, frac=frac)
    got = A.evaluate_accelerator_grid(W.CNN_WORKLOADS[wl](), _mixes(A), nets, dev,
                                      mem_bw, frac=frac, device=CPU)
    for f in REPORT_FIELDS:
        _close(got[f], want[f], f)


def _mix_math_args(seed, mod, n=8):
    r, nets, dev, mem_bw = _grid_inputs(seed, n)
    wl = JW.CNN_WORKLOADS["ResNet18"]()
    lc = JA.layer_columns(wl)
    cc = JA.chiplet_mix_columns(_mixes(JA)[1:2])
    cc = {k: v[0] for k, v in cc.items()}
    return cc, lc, nets, dev, mem_bw


MAC_SLOW = 2e7


def _ref_relaxed_latency(vec, mac, cc, lc, nets, dev, mem_bw):
    out = JA._accel_mix_math(
        {"n_units": jnp.asarray(cc["n_units"]), "vector_size": vec}, None,
        {k: jnp.asarray(v) for k, v in lc.items()},
        {k: jnp.asarray(v) for k, v in nets.items()},
        {k: jnp.asarray(v) for k, v in dev.items()}, jnp.asarray(mem_bw), mac,
        jnp.asarray(30e-15), jnp.asarray(16.0), adaptive=True, relaxed=True)
    return out["latency_s"].sum()


def test_relaxed_mix_math_value_and_gradient_match():
    """The relaxed (continuous) accelerator latency and its gradient with
    respect to the per-chiplet vector sizes and the MAC rate, through the
    in-kernel PCMC planner, against `jax.grad` of the reference."""
    cc, lc, nets, dev, mem_bw = _mix_math_args(11, JA)
    # a slow MAC rate, so that compute bounds some layers and not others
    with JPW.engine_x64():
        vec0, mac0 = jnp.asarray(cc["vector_size"]), jnp.asarray(MAC_SLOW)
        want_v = float(_ref_relaxed_latency(vec0, mac0, cc, lc, nets, dev, mem_bw))
        gv, gm = jax.grad(_ref_relaxed_latency, argnums=(0, 1))(
            vec0, mac0, cc, lc, nets, dev, mem_bw)
        gv, gm = np.asarray(gv), float(gm)

    vec = torch.tensor(cc["vector_size"], dtype=torch.float64, requires_grad=True)
    mac = torch.tensor(MAC_SLOW, dtype=torch.float64, requires_grad=True)
    out = A._accel_mix_math(
        {"n_units": torch.from_numpy(cc["n_units"]), "vector_size": vec}, None,
        {k: torch.from_numpy(v) for k, v in lc.items()},
        {k: torch.from_numpy(v) for k, v in nets.items()},
        {k: torch.from_numpy(v) for k, v in dev.items()}, torch.from_numpy(mem_bw),
        mac, XT.asarray(30e-15), XT.asarray(16.0), adaptive=True, relaxed=True)
    lat = out["latency_s"].sum()
    got_v, got_m = torch.autograd.grad(lat, (vec, mac))
    np.testing.assert_allclose(float(lat.detach()), want_v, rtol=RTOL, atol=0)
    assert np.any(gv != 0) and gm != 0
    np.testing.assert_allclose(got_v.numpy(), gv, rtol=GRAD_RTOL, atol=0)
    np.testing.assert_allclose(float(got_m), gm, rtol=GRAD_RTOL, atol=0)


@pytest.mark.parametrize("relaxed", [False, True])
def test_mix_math_all_fields_match(relaxed):
    cc, lc, nets, dev, mem_bw = _mix_math_args(12, JA, n=24)
    with JPW.engine_x64():
        want = JA._accel_mix_math(
            {k: jnp.asarray(v) for k, v in cc.items()}, None,
            {k: jnp.asarray(v) for k, v in lc.items()},
            {k: jnp.asarray(v) for k, v in nets.items()},
            {k: jnp.asarray(v) for k, v in dev.items()}, jnp.asarray(mem_bw),
            jnp.asarray(5e9), jnp.asarray(30e-15), jnp.asarray(16.0),
            adaptive=True, relaxed=relaxed)
        want = {k: np.asarray(v) for k, v in want.items()}
    got = A._accel_mix_math(
        {k: torch.from_numpy(v) for k, v in cc.items()}, None,
        {k: torch.from_numpy(v) for k, v in lc.items()},
        {k: torch.from_numpy(v) for k, v in nets.items()},
        {k: torch.from_numpy(v) for k, v in dev.items()}, torch.from_numpy(mem_bw),
        XT.asarray(5e9), XT.asarray(30e-15), XT.asarray(16.0),
        adaptive=True, relaxed=relaxed)
    for f in REPORT_FIELDS:
        _close(got[f], want[f], f)


def test_accelerator_zero_unit_padding_parity():
    """Zero-unit chiplets are inert on both paths: a padded accelerator
    scores as its unpadded twin (exactly on the host loop, at rtol 1e-12 on
    the batched path, against the reference's batched path)."""
    wl = W.CNN_WORKLOADS["LeNet5"]()
    clean = A.crosslight_25d_siph()
    padded = dataclasses.replace(clean, chiplets=list(clean.chiplets) + [A.ChipletSpec(0, 1)])
    jclean = JA.crosslight_25d_siph()
    jpadded = dataclasses.replace(jclean, chiplets=list(jclean.chiplets) + [JA.ChipletSpec(0, 1)])
    jwl = JW.CNN_WORKLOADS["LeNet5"]()
    for f in REPORT_FIELDS:
        assert getattr(A.evaluate_accelerator(padded, wl), f) == \
            getattr(A.evaluate_accelerator(clean, wl), f), f
        _close(getattr(A.evaluate_accelerator_batch(padded, wl, device=CPU), f),
               getattr(JA.evaluate_accelerator_batch(jpadded, jwl), f), f)
        assert getattr(A.evaluate_accelerator_batch(padded, wl, device=CPU), f) == \
            pytest.approx(getattr(A.evaluate_accelerator_batch(clean, wl, device=CPU), f),
                          rel=1e-12), f


def test_accelerator_all_zero_mix_raises():
    wl = W.CNN_WORKLOADS["LeNet5"]()
    dead = dataclasses.replace(A.crosslight_25d_siph(),
                               chiplets=[A.ChipletSpec(0, 9), A.ChipletSpec(0, 49)])
    with pytest.raises(ValueError, match="no active"):
        A.evaluate_accelerator(dead, wl)
    with pytest.raises(ValueError, match="no active"):
        A.chiplet_mix_columns([[A.ChipletSpec(512, 32)], [A.ChipletSpec(0, 9)]])


def test_accelerator_entry_points_need_a_device_and_stay_float64():
    """The batched entry points default to the card and raise without one
    (no fallback); their results are float64 whatever the default dtype."""
    wl, accel = W.CNN_WORKLOADS["LeNet5"](), A.crosslight_25d_siph()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            A.evaluate_accelerator_batch(accel, wl)
    ref = A.evaluate_accelerator_batch(accel, wl, device=CPU)
    _, nets, dev, mem_bw = _grid_inputs(13, 8)
    grid64 = A.evaluate_accelerator_grid(wl, [accel.chiplets], nets, dev, mem_bw, device=CPU)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    try:
        got = A.evaluate_accelerator_batch(accel, wl, device=CPU)
        grid32 = A.evaluate_accelerator_grid(wl, [accel.chiplets], nets, dev, mem_bw,
                                             device=CPU, as_numpy=False)
    finally:
        torch.set_default_dtype(old)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for f in REPORT_FIELDS:
        assert grid32[f].dtype == torch.float64
        np.testing.assert_array_equal(grid32[f].numpy(), grid64[f])
