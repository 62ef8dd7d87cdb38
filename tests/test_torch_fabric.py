"""Parity of the port's fabric layer (`repro_torch.core.fabric`) and the
fault-epoch hooks it feeds (`ContinuousBatcher(fabric=)`,
`Trainer(fabric=)`) with the JAX package's on the CPU, and
`benchmarks/torch_resilience_bench.py` against `resilience_bench.py`.

Tolerances: float64 link numbers, modelled seconds and bench curves at rtol
1e-12, atol 0 against the reference; names, sources, channel counts, fault
iterations and replan counts exactly; tokens and losses under a fabric bit
for bit equal to the port's own fabric-less run (the model changes no
numerics).  The reference's own tolerances for the identity of a HEALTHY
degradation (rtol 1e-5 on bandwidth, 1e-3 on energy per bit) are kept where
the port is held against itself.
"""

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest

# `repro.core.power` imports `jax.experimental.enable_x64`; newer jax only
# has `jax.enable_x64`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from repro import configs as JC  # noqa: E402
from repro.core import fabric as JFb  # noqa: E402
from repro.core import faults as JF  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro.core.topology import TOPOLOGIES as JTOPOLOGIES  # noqa: E402
from repro.core.topology import NetworkParams as JNetworkParams  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.runtime import trainer as JT  # noqa: E402
from repro.serve.engine import ContinuousBatcher as JContinuousBatcher  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.core import fabric as Fb  # noqa: E402
from repro_torch.core import faults as F  # noqa: E402
from repro_torch.core import planner as P  # noqa: E402
from repro_torch.core.topology import TOPOLOGIES, NetworkParams  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.serve.engine import ContinuousBatcher  # noqa: E402

RTOL = 1e-12
CPU = "cpu"
PRESETS = tuple(Fb.FABRIC_PRESETS)
MODEL_ARGS = dict(p_lambda=0.15, p_bank=0.12, p_gateway=0.05, wpe_loss=0.2,
                  drift_sigma_db=0.5, tuning_sigma=0.3)
MODEL, JMODEL = F.FaultModel(**MODEL_ARGS), JF.FaultModel(**MODEL_ARGS)


def _scen(scenario):
    """The reference's FaultScenario with the same fields."""
    return JF.FaultScenario(**{f.name: getattr(scenario, f.name)
                               for f in dataclasses.fields(scenario)})


# three scenarios: the expected one at severity 1 and 2, and a hand-made one
# that kills gateways, wavelengths and banks at once
SCENARIOS = {
    "expected": MODEL.expected(),
    "sev2": MODEL.scale(2.0).expected(name="sev2"),
    "hand": F.FaultScenario(dead_lambda_frac=0.25, failed_laser_banks=2.0,
                            failed_gateways=3.0, wpe_factor=0.8, drift_db=0.3,
                            tuning_factor=1.2, name="hand"),
}


def _same_fabric(got, want, ctx):
    """Every field: floats at RTOL (equal infinities count as equal),
    everything else exactly."""
    assert type(got).__name__ == "Fabric"
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, float) and not (np.isinf(b) and a == b):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=f"{ctx}/{f.name}")
        else:
            assert a == b, (ctx, f.name, a, b)


# ---------------------------------------------------------------------------
# constructors and term helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_reference(name):
    got, want = Fb.get_fabric(name), JFb.get_fabric(name)
    _same_fabric(got, want, name)
    assert got.name == name
    assert got.intra_pod_bw_bytes_per_s >= got.cross_pod_bw_bytes_per_s
    assert got.peak_flops == Fb.DEFAULT_PEAK_FLOPS == JFb.DEFAULT_PEAK_FLOPS
    assert got.hbm_bw_bytes_per_s == Fb.DEFAULT_HBM_BW == JFb.DEFAULT_HBM_BW


def test_presets_bracket_the_metallic_baseline():
    cross = {n: Fb.get_fabric(n).cross_pod_bw_bytes_per_s for n in PRESETS}
    assert cross["metallic_ici"] == Fb.METALLIC_ICI_BW == 50e9
    assert cross["trine_siph"] > cross["metallic_ici"] > cross["tree_siph"]
    assert cross["elec_mesh"] < cross["tree_siph"]


@pytest.mark.parametrize("cfg", [
    {"topology": "trine"},
    {"topology": "trine", "n_lambda": 16.0, "mem_bw_bytes_per_s": 200e9,
     "mix": 1, "chiplets": (), "mac_rate_hz": 4e9},          # compute keys ignored
    {"topology": "tree", "n_gateways": 48.0, "mzi.insertion_loss_db": 1.5},
    {"topology": "spacx", "n_gateways": 16.0, "modulation_rate_bps": 16e9},
    {"topology": "elec", "interposer_side_cm": 3.0},
    {"topology": "trine", "n_subnetworks": 4.0, "laser.wall_plug_efficiency": 0.1},
])
def test_from_config_matches_reference(cfg):
    got = Fb.Fabric.from_config(cfg)
    want = JFb.Fabric.from_config(cfg)
    _same_fabric(got, want, str(cfg))
    assert got.source["topology"] == cfg["topology"]


def test_from_config_refuses_unknown_columns_and_topologies():
    with pytest.raises(KeyError, match="unknown config column"):
        Fb.Fabric.from_config({"topology": "trine", "warp_factor": 9.0})
    with pytest.raises(KeyError, match="unknown topology"):
        Fb.Fabric.from_config({"topology": "subspace"})


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_from_network_model_matches_reference(topo):
    p = dict(n_gateways=48, n_lambda=12)
    got = Fb.Fabric.from_network_model(TOPOLOGIES[topo](NetworkParams(**p)), name="t",
                                       hbm_bw_bytes_per_s=1e12, source={"k": 1.0})
    want = JFb.Fabric.from_network_model(JTOPOLOGIES[topo](JNetworkParams(**p)), name="t",
                                         hbm_bw_bytes_per_s=1e12, source={"k": 1.0})
    _same_fabric(got, want, topo)


def test_fabric_term_helpers_and_resolution():
    kw = dict(hbm_bw_bytes_per_s=800e9, peak_flops=100e12, link_latency_s=1e-7,
              energy_per_bit_j=1e-12)
    fb, jfb = Fb.Fabric("f", 10e9, 20e9, **kw), JFb.Fabric("f", 10e9, 20e9, **kw)
    assert fb.compute_s(1e12) == jfb.compute_s(1e12)
    assert fb.memory_s(8e9) == jfb.memory_s(8e9)
    assert fb.collective_s(1e9, 5) == jfb.collective_s(1e9, 5)
    assert fb.collective_energy_j(1e9) == jfb.collective_energy_j(1e9)
    assert Fb.get_fabric(None) is Fb.DEFAULT_FABRIC
    assert Fb.get_fabric(fb) is fb
    assert Fb.get_fabric("tree_siph").name == "tree_siph"
    with pytest.raises(KeyError, match="unknown fabric preset"):
        Fb.get_fabric("copper_dream")
    with pytest.raises(TypeError):
        Fb.get_fabric(42)


# ---------------------------------------------------------------------------
# degrade, the overlapped step, the channel plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PRESETS)
def test_degrade_healthy_is_identity_and_matches_reference(name):
    fb = Fb.get_fabric(name)
    fh = Fb.degrade(fb, F.HEALTHY, device=CPU)
    _same_fabric(fh, JFb.degrade(JFb.get_fabric(name), JF.HEALTHY), f"{name}|healthy")
    assert np.isclose(fh.cross_pod_bw_bytes_per_s, fb.cross_pod_bw_bytes_per_s, rtol=1e-5)
    assert np.isclose(fh.energy_per_bit_j, fb.energy_per_bit_j, rtol=1e-3)
    assert fh.name == f"{name}|healthy" and fh.source["degraded"] == 1.0


@pytest.mark.parametrize("scen", sorted(SCENARIOS))
@pytest.mark.parametrize("name", PRESETS)
def test_degrade_matches_reference(name, scen):
    s = SCENARIOS[scen]
    got = Fb.degrade(name, s, device=CPU)
    _same_fabric(got, JFb.degrade(name, _scen(s)), f"{name}|{scen}")
    healthy = Fb.get_fabric(name)
    assert got.cross_pod_bw_bytes_per_s <= healthy.cross_pod_bw_bytes_per_s


def test_degrade_of_a_config_fabric_matches_reference():
    cfg = {"topology": "trine", "n_lambda": 16.0, "n_gateways": 48.0}
    got = Fb.degrade(Fb.Fabric.from_config(cfg), SCENARIOS["sev2"], device=CPU)
    want = JFb.degrade(JFb.Fabric.from_config(cfg), _scen(SCENARIOS["sev2"]))
    _same_fabric(got, want, "config|sev2")


def test_degrade_metallic_only_loses_ports():
    sc = F.FaultScenario(failed_gateways=8.0, dead_lambda_frac=0.9, failed_laser_banks=4.0)
    fb = Fb.get_fabric("metallic_ici")
    fd = Fb.degrade(fb, sc, device=CPU)    # photonic knobs are no-ops on metallic links
    _same_fabric(fd, JFb.degrade("metallic_ici", _scen(sc)), "metallic")
    np.testing.assert_allclose(fd.cross_pod_bw_bytes_per_s,
                               fb.cross_pod_bw_bytes_per_s * 24 / 32)
    assert fd.energy_per_bit_j == fb.energy_per_bit_j


def test_degrade_rejects_batched_scenarios():
    with pytest.raises(ValueError, match="scalar scenario"):
        Fb.degrade("trine_siph", MODEL.sample(4, rng=0), device=CPU)


def test_degrade_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        Fb.degrade("trine_siph", MODEL.expected())


def test_dead_fabric_hard_fails_channel_planning():
    dead = Fb.degrade("tree_siph", F.FaultScenario(failed_laser_banks=1.0), device=CPU)
    _same_fabric(dead, JFb.degrade("tree_siph", JF.FaultScenario(failed_laser_banks=1.0)),
                 "tree|dead")
    assert dead.cross_pod_bw_bytes_per_s == 0.0 and dead.energy_per_bit_j == float("inf")
    with pytest.raises(F.FabricUnusableError):
        P.plan_collective_channels(1 << 30, 0.05, fabric=dead)
    assert Fb.overlapped_step_s(0.05, 1 << 30, dead, 4) == float("inf")


def test_overlapped_step_and_channel_plan_match_reference():
    r = np.random.default_rng(5)
    for name in PRESETS:
        for scen in (None, *SCENARIOS.values()):
            fb = Fb.get_fabric(name) if scen is None else Fb.degrade(name, scen, device=CPU)
            jfb = JFb.get_fabric(name) if scen is None else JFb.degrade(name, _scen(scen))
            if fb.cross_pod_bw_bytes_per_s <= 0:      # dead: both refuse to plan
                assert jfb.cross_pod_bw_bytes_per_s <= 0
                with pytest.raises(F.FabricUnusableError):
                    P.plan_collective_channels(1e9, 0.05, fabric=fb)
                continue
            for _ in range(8):
                b, w = float(r.uniform(1e6, 8e9)), float(r.uniform(1e-3, 1e-1))
                ch = P.plan_collective_channels(b, w, fabric=fb, max_channels=64)
                assert ch == JP.plan_collective_channels(b, w, fabric=jfb, max_channels=64)
                np.testing.assert_allclose(Fb.overlapped_step_s(w, b, fb, ch),
                                           JFb.overlapped_step_s(w, b, jfb, ch),
                                           rtol=RTOL, atol=0)


def test_plan_collective_channels_by_name():
    args = dict(collective_bytes=2e9, overlap_window_s=10e-3, max_channels=64)
    by_bw = P.plan_collective_channels(link_bw_bytes_per_s=50e9, **args)
    by_name = P.plan_collective_channels(fabric="metallic_ici", **args)
    by_obj = P.plan_collective_channels(fabric=Fb.metallic_ici(), **args)
    assert by_bw == by_name == by_obj == 4
    assert P.plan_collective_channels(fabric="tree_siph", **args) > by_bw
    # the fabric under evaluation wins over a stale explicit bandwidth
    assert P.plan_collective_channels(link_bw_bytes_per_s=1e30, fabric="tree_siph",
                                      **args) > by_bw


def test_replanning_recovers_at_least_naive_throughput():
    fb = Fb.get_fabric("trine_siph")
    fbd = Fb.degrade(fb, MODEL.scale(2.0).expected(), device=CPU)
    ch0 = P.plan_collective_channels(2 << 30, 0.05, fabric=fb, max_channels=64)
    ch1 = P.plan_collective_channels(2 << 30, 0.05, fabric=fbd, max_channels=64)
    assert ch1 >= ch0
    naive = Fb.overlapped_step_s(0.05, 2 << 30, fbd, ch0)
    replanned = Fb.overlapped_step_s(0.05, 2 << 30, fbd, ch1)
    assert replanned <= naive * (1 + 1e-12)


# ---------------------------------------------------------------------------
# the batcher's fault epoch
# ---------------------------------------------------------------------------

MAX_LEN = 64
FAULT_ITER = 2


def _serving_setup(arch="yi_6b"):
    jcfg, cfg = JC.get_reduced(arch), C.get_reduced(arch)
    jparams, _ = JM.init(jcfg, jax.random.PRNGKey(0))
    params = params_from_reference(cfg, jax.tree.map(np.asarray, jparams), device=CPU)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab, n)] for n in (5, 7, 3)]
    return jcfg, jparams, cfg, params, prompts


def _serve(eng, prompts, **run_kw):
    reqs = [eng.submit(p, 4) for p in prompts]
    eng.run(**run_kw)
    return [r.out for r in reqs]


def test_batcher_fault_epoch_matches_reference():
    """Tokens under a fabric equal the port's fabric-less run bit for bit;
    `net_stats`, the channel plan and the fabric equal the reference
    batcher's on the same weights (`models/convert.py`)."""
    jcfg, jparams, cfg, params, prompts = _serving_setup()
    scen = MODEL.scale(2.0).expected()

    plain = ContinuousBatcher(cfg, params, n_slots=2, max_len=MAX_LEN, device=CPU)
    plain_out = _serve(plain, prompts)
    assert plain.net_stats["modeled_net_s"] == 0.0 and plain.net_stats["replans"] == 0
    with pytest.raises(ValueError, match="no fabric"):
        plain.inject_fault(scen)

    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=MAX_LEN, fabric="trine_siph",
                            device=CPU)
    healthy_channels = eng.collective_channels
    out = _serve(eng, prompts, fault_at_iter=FAULT_ITER, fault_scenario=scen)
    jeng = JContinuousBatcher(jcfg, jparams, n_slots=2, max_len=MAX_LEN, fabric="trine_siph")
    jhealthy_channels = jeng.collective_channels
    jout = _serve(jeng, prompts, fault_at_iter=FAULT_ITER, fault_scenario=_scen(scen))

    assert out == plain_out == jout
    assert healthy_channels == jhealthy_channels
    assert eng.collective_channels == jeng.collective_channels
    for k in ("decode_iters", "fault_iter", "replans"):
        assert eng.net_stats[k] == jeng.net_stats[k], k
    assert eng.net_stats["fault_iter"] == FAULT_ITER and eng.net_stats["replans"] == 2
    assert eng.net_stats["decode_iters"] == eng.stats["decode_iters"] >= 4
    np.testing.assert_allclose(eng.net_stats["modeled_net_s"], jeng.net_stats["modeled_net_s"],
                               rtol=RTOL, atol=0)
    assert eng.net_stats["modeled_net_s"] > 0.0
    _same_fabric(eng.fabric, jeng.fabric, "batcher fabric")
    assert eng.fabric.name.endswith("|expected")


def test_batcher_hard_fails_on_unusable_fabric():
    jcfg, jparams, cfg, params, _ = _serving_setup()
    dead = F.FaultScenario(failed_laser_banks=1.0)
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=MAX_LEN, fabric="tree_siph",
                            device=CPU)
    eng.submit([3, 4, 5], 4)
    with pytest.raises(F.FabricUnusableError):
        eng.run(fault_at_iter=1, fault_scenario=dead)
    jeng = JContinuousBatcher(jcfg, jparams, n_slots=2, max_len=MAX_LEN, fabric="tree_siph")
    jeng.submit([3, 4, 5], 4)
    with pytest.raises(JF.FabricUnusableError):
        jeng.run(fault_at_iter=1, fault_scenario=_scen(dead))
    assert eng.net_stats["decode_iters"] == jeng.net_stats["decode_iters"] == 1


# ---------------------------------------------------------------------------
# the trainer's fault epoch
# ---------------------------------------------------------------------------

CFG = C.get_reduced("yi_6b")
OPT = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=16)
DATA = DataConfig(global_batch=2, seq_len=64)
FAULT_AT = 4


def _trainer(tmp, **kw):
    return Trainer(CFG, OPT, DATA, TrainerConfig(ckpt_dir=str(tmp), ckpt_every=2, log_every=1000),
                   resume=False, device=CPU, **kw)


def _ref_trainer(tmp, **kw):
    return JT.Trainer(JC.get_reduced("yi_6b"), JA.OptConfig(lr=1e-3, warmup_steps=2,
                                                            total_steps=16),
                      JDataConfig(global_batch=2, seq_len=64),
                      JT.TrainerConfig(ckpt_dir=str(tmp), ckpt_every=2, log_every=1000),
                      resume=False, **kw)


def test_trainer_fault_epoch_matches_reference(tmp_path):
    """A fault at step 4: the fabric degrades, the collective replans, and
    the loss trajectory is the fabric-less run's bit for bit.  The channel
    plan equals the reference trainer's exactly (healthy and degraded), the
    exposed network seconds at RTOL."""
    scen = MODEL.scale(2.0).expected()
    plain = _trainer(tmp_path / "plain")
    plain.run(6, quiet=True)
    tr = _trainer(tmp_path / "fault", fabric="trine_siph")
    jt = _ref_trainer(tmp_path / "ref", fabric="trine_siph")
    assert tr.tcfg.overlap_window_s == jt.tcfg.overlap_window_s == 50e-3
    assert tr._grad_bytes == jt._grad_bytes == 4.0 * sum(
        p.numel() for p in T.leaves(tr.state.params))
    assert tr.collective_channels == jt.collective_channels
    np.testing.assert_allclose(tr.net_s, jt.net_s, rtol=RTOL, atol=0)
    net_s_healthy = tr.net_s

    out = tr.run(6, quiet=True, fault_at=FAULT_AT, fault_scenario=scen)
    jt.inject_fault(_scen(scen))
    assert [h["step"] for h in tr.history] == [1, 2, 3, 4, 5, 6]
    assert [h["loss"] for h in tr.history] == [h["loss"] for h in plain.history]
    assert [h["grad_norm"] for h in tr.history] == [h["grad_norm"] for h in plain.history]
    assert all("net_s" not in h for h in plain.history)
    assert [h["net_s"] for h in tr.history[:FAULT_AT - 1]] == [net_s_healthy] * (FAULT_AT - 1)
    assert all(h["net_s"] == tr.net_s > net_s_healthy for h in tr.history[FAULT_AT - 1:])
    assert out["collective_channels"] == tr.collective_channels == jt.collective_channels
    np.testing.assert_allclose(out["net_s"], jt.net_s, rtol=RTOL, atol=0)
    assert out["fabric"] == jt.fabric.name and out["fabric"].endswith("|expected")
    _same_fabric(tr.fabric, jt.fabric, "trainer fabric")


def test_trainer_hard_fails_on_unusable_fabric(tmp_path):
    dead = F.FaultScenario(failed_laser_banks=1.0)
    tr = _trainer(tmp_path / "t", fabric="tree_siph")
    with pytest.raises(F.FabricUnusableError):
        tr.run(4, quiet=True, fault_at=2, fault_scenario=dead)
    assert [h["step"] for h in tr.history] == [1]
    jt = _ref_trainer(tmp_path / "j", fabric="tree_siph")
    with pytest.raises(JF.FabricUnusableError):
        jt.inject_fault(_scen(dead))


def test_launch_train_main_carries_a_fabric(tmp_path):
    from repro_torch.launch import train as launch_train
    trainer, out = launch_train.main(
        ["--arch", "yi-6b", "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "32", "--ckpt", str(tmp_path), "--no-resume"],
        fabric="trine_siph", fault_at=2, fault_scenario=MODEL.expected())
    assert out["fabric"] == "trine_siph|expected"
    net = [h["net_s"] for h in trainer.history]
    assert net[0] < net[1] == net[2]


# ---------------------------------------------------------------------------
# benchmarks/torch_resilience_bench.py against the reference's
# ---------------------------------------------------------------------------


def test_torch_resilience_bench_matches_reference():
    import benchmarks.resilience_bench as ref
    import benchmarks.torch_resilience_bench as port
    got, want = port.run(csv=False, smoke=True, device=CPU), ref.run(csv=False, smoke=True)
    assert got["checks"] == want["checks"] and all(got["checks"].values())
    assert got["required_checks"] == want["required_checks"] and got["pass"]
    assert got["availability"] == want["availability"]
    for part in ("degradation", "recovery"):
        assert len(got[part]) == len(want[part])
        for a, b in zip(got[part], want[part]):
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(b[k], (str, int)):
                    assert a[k] == b[k], (part, k)
                else:
                    np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=0,
                                               err_msg=f"{part}/{k}")
    g, w = got["yield_grid"], want["yield_grid"]
    for k in ("n_points", "n_scenarios", "chunk_size", "materialize", "prefetch_depth",
              "edp_ge_healthy"):
        assert g[k] == w[k], k
    for k in ("epb_budget_j", "availability_min", "availability_max", "availability_mean"):
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=0, err_msg=k)
    gb, wb = g["best_survivable"], w["best_survivable"]
    assert (gb["index"], gb["config"], gb["availability"]) == \
        (wb["index"], wb["config"], wb["availability"])
    np.testing.assert_allclose(gb["expected_edp"], wb["expected_edp"], rtol=RTOL, atol=0)
