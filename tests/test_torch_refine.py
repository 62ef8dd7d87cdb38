"""Parity of the port's refinement engines (`repro_torch.core.search`:
`refine_continuous`, `refine_front_point`, `refine_codesign` in both methods,
`refine_trust_region`, `refine_front` and their host-side helpers), its
analytic roofline (`repro_torch.launch.hlo_analysis`), the refine sections of
`benchmarks/torch_pareto_bench.py` and `examples/torch_photonic_design_space.py`
with the JAX package's on the CPU, and the counterparts of the reference's
own refine tests (`tests/test_search.py`).

The port refines in float64 throughout; the reference runs its first-order
paths at jax's default precision and only its trust-region path in forced
float64.  So the port is held against the reference run inside
`repro.core.power.engine_x64()` (a context manager: `jax_enable_x64` is
never flipped for the process), and one test records how the reference's
float32 first-order path differs.

Tolerances: integer designs, candidate counts, trust-region accept/reject
counts and line-search counts exactly; loss traces, relaxed values,
sensitivities, values and metrics at rtol 1e-9, atol 0; the relaxed
co-design loss, its gradient and its Hessian at rtol 1e-10 against
`jax.value_and_grad`/`jax.hessian`; the host-side helpers bit for bit on the
same plain-python callables; the roofline field for field.  Grids and seeds
are those of `tests/test_search.py`, at its sizes.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

# `repro.core.power` imports `jax.experimental.enable_x64`; newer jax only
# has `jax.enable_x64`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402

from repro.core import search as JS  # noqa: E402
from repro.core import fabric as JFAB  # noqa: E402
from repro.core.accelerator import ChipletSpec as JChipletSpec  # noqa: E402
from repro.core.accelerator import _accel_mix_math as j_accel_mix_math  # noqa: E402
from repro.core.accelerator import layer_columns as j_layer_columns  # noqa: E402
from repro.core.power import EVAL_DEVICE_FIELDS as J_DEV_FIELDS  # noqa: E402
from repro.core.power import engine_x64  # noqa: E402
from repro.core.sweep import _as_f64  # noqa: E402
from repro.core.sweep import grid_spec as j_grid_spec  # noqa: E402
from repro.core.topology import MODEL_FIELDS as J_MODEL_FIELDS  # noqa: E402
from repro.core.topology import TOPOLOGY_ARRAYS as J_TOPOLOGY_ARRAYS  # noqa: E402
from repro.core.workloads import CNN_WORKLOADS as JCNN  # noqa: E402
from repro.launch import hlo_analysis as JH  # noqa: E402

from repro_torch.core import fabric as FAB  # noqa: E402
from repro_torch.core import search as S  # noqa: E402
from repro_torch.core.accelerator import ChipletSpec  # noqa: E402
from repro_torch.core.accelerator import evaluate_accelerator_grid  # noqa: E402
from repro_torch.core.sweep import _network_columns_arrays, grid_spec  # noqa: E402
from repro_torch.core.workloads import CNN_WORKLOADS  # noqa: E402
from repro_torch.core.xp import TorchNS  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402

RTOL = 1e-9
HESS_RTOL = 1e-10
CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
TR_AXES = ("modulation_rate_bps", "mem_bw_bytes_per_s",
           "interposer_side_cm", "n_gateways")
MIXES = [[(256, 9), (128, 49)], [(512, 32)], [(128, 9), (128, 27), (64, 128)]]


def _close(got, want, ctx, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=0, err_msg=str(ctx))


def _close_vec(got, want, ctx, rtol=RTOL):
    """A gradient-like vector: rtol elementwise, and entries that are zero
    up to cancellation (a flat axis) against the vector's scale."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * np.abs(want).max(initial=0.0), err_msg=str(ctx))


def _chips(chiplets):
    return [(int(c.n_units), int(c.vector_size)) for c in chiplets]


# ---------------------------------------------------------------------------
# the co-design setup of tests/test_search.py, on both sides
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _setup():
    """(port: wl, mixes, front, spec), (reference: the same) — the
    reference's `_codesign_refine_setup` grid; the two fronts are equal."""
    axes = dict(n_gateways=(16, 32), n_lambda=(4, 8))
    wl, jwl = CNN_WORKLOADS["LeNet5"](), JCNN["LeNet5"]()
    mixes = [[ChipletSpec(*c) for c in m] for m in MIXES]
    jmixes = [[JChipletSpec(*c) for c in m] for m in MIXES]
    front, spec = S.codesign_pareto(wl, mixes, topologies=("trine", "tree"),
                                    chunk_size=7, device=CPU, **axes)
    jfront, jspec = JS.codesign_pareto(jwl, jmixes, topologies=("trine", "tree"),
                                       chunk_size=7, **axes)
    np.testing.assert_array_equal(front.indices, jfront.indices)
    return (wl, mixes, front, spec), (jwl, jmixes, jfront, jspec)


def _rounding_boundary(r, jr, ctx):
    """Where the two packages snap to different integer designs, the snap
    must have been decided by rounding: every discrete axis on which the
    designs differ was relaxed (on both sides, to rtol 1e-9 of each other)
    to within 1e-9 of one integer, so floor/ceil of a value a few ulps on
    either side of it give different neighbor sets.  That happens on a flat
    axis (zero gradient up to rounding noise) that the trust-region step,
    damped at 1e-6, moves by the noise over the damping.  Returns whether
    the designs differ."""
    got, want = r["refined"]["config"], jr["refined"]["config"]
    diff = []
    for j, (c, jc) in enumerate(zip(got["chiplets"], want["chiplets"])):
        if c.n_units != jc.n_units:
            diff.append(f"n_units[{j}]")
        if c.vector_size != jc.vector_size:
            diff.append(f"vector_size[{j}]")
    diff += [k for k in r["relaxed"] if k in want and isinstance(want[k], float)
             and float(got[k]) != want[k] and float(want[k]).is_integer()]
    for k in diff:
        for x in (r["relaxed"][k], jr["relaxed"][k]):
            assert abs(x - round(x)) <= 1e-9 * abs(x), (ctx, k, x, "not a rounding boundary")
    if diff:
        print(f"{ctx}: the snap of {diff} is decided by rounding: port "
              f"{_chips(got['chiplets'])} ({r['refined']['value']!r}), reference "
              f"{_chips(want['chiplets'])} ({jr['refined']['value']!r})")
    return bool(diff)


def _same_codesign(r, jr, ctx):
    """A port `refine_codesign` result against the reference's: discrete
    outcomes exactly, continuous ones at RTOL.  Returns whether the snapped
    designs differ on a rounding boundary (`_rounding_boundary`), in which
    case what describes the refined design is not compared."""
    ctx = f"{ctx} seed {jr['flat_index']}"
    for k in ("flat_index", "topology", "objective", "method", "workloads", "labels",
              "n_candidates"):
        assert r[k] == jr[k], (ctx, k)
    _close(r["weights"], jr["weights"], ctx)
    _close(r["loss_trace"], jr["loss_trace"], (ctx, "trace"))
    assert list(r["relaxed"]) == list(jr["relaxed"])
    _close(list(r["relaxed"].values()), list(jr["relaxed"].values()), (ctx, "relaxed"))
    assert list(r["sensitivity"]) == list(jr["sensitivity"])
    _close_vec(list(r["sensitivity"].values()), list(jr["sensitivity"].values()),
               (ctx, "sensitivity"))
    boundary = _rounding_boundary(r, jr, ctx)
    for blk in ("seed",) if boundary else ("seed", "refined"):
        cfg, jcfg = dict(r[blk]["config"]), dict(jr[blk]["config"])
        assert _chips(cfg.pop("chiplets")) == _chips(jcfg.pop("chiplets")), (ctx, blk)
        assert set(cfg) == set(jcfg), (ctx, blk)
        for k, v in jcfg.items():
            if isinstance(v, str) or k == "mix":
                assert cfg[k] == v, (ctx, blk, k)
            else:
                _close(cfg[k], v, (ctx, blk, k))
        _close(r[blk]["value"], jr[blk]["value"], (ctx, blk))
        assert len(r[blk]["per_workload"]) == len(jr[blk]["per_workload"])
        for m, jm in zip(r[blk]["per_workload"], jr[blk]["per_workload"]):
            assert set(m) == set(jm)
            for k in jm:
                _close(m[k], jm[k], (ctx, blk, k))
    for blk in ("seed", "refined"):
        assert r[blk]["metrics"] == r[blk]["per_workload"][0]
    if not boundary:
        _close(r["improvement"], jr["improvement"], ctx, rtol=1e-7)
    if jr["tr_stats"] is None:
        assert r["tr_stats"] is None and r["line_search"] is None
        return boundary
    st, jst = r["tr_stats"], jr["tr_stats"]
    for k in ("accepted", "rejected", "stopped_early"):
        assert st[k] == jst[k], (ctx, k)
    _close(st["radius_trace"], jst["radius_trace"], (ctx, "radius"))
    ls, jls = r["line_search"], jr["line_search"]
    assert (ls["n_scored"], ls["n_sweeps"]) == (jls["n_scored"], jls["n_sweeps"]), ctx
    if not boundary:
        _close([ls["snap_value"], ls["value"]], [jls["snap_value"], jls["value"]], ctx)
    return boundary


def _rescore(r, spec, wls):
    """Standalone exact re-score of a refined config on the CPU: every
    per-workload metric must come back bit for bit."""
    cfg = r["refined"]["config"]
    cols = {k: np.full(1, v, np.float64) for k, v in spec.base.items()}
    for k, v in cfg.items():
        if k in cols:
            cols[k][:] = float(v)
    nets = _network_columns_arrays(cols, np.zeros(1, np.int64), (cfg["topology"],))
    for w, per in zip(wls, r["refined"]["per_workload"]):
        out = evaluate_accelerator_grid(
            w, [cfg["chiplets"]], nets, cols,
            cols["n_mem_chiplets"] * cols["mem_bw_bytes_per_s"],
            mac_rate_hz=cfg["mac_rate_hz"],
            lambda_slot_energy_j=cfg["lambda_slot_energy_j"], device=CPU)
        for k, v in per.items():
            assert float(out[k][0, 0]) == v, (w.name, k)


# ---------------------------------------------------------------------------
# host-side helpers against the reference's, bit for bit
# ---------------------------------------------------------------------------


def _quadratic(A, c):
    def vg(x):
        d = np.asarray(x, np.float64) - c
        return 0.5 * float(d @ A @ d), A @ d
    return vg


def _liar(x):
    x = np.asarray(x, np.float64)
    return float(x @ x), -2.0 * x  # honest value, lying gradient


def _far(x):
    d = np.asarray(x, np.float64) - 10.0
    return float(d @ d), 2.0 * d


TR_CASES = {
    "exact_quadratic": (_quadratic(np.diag([1.0, 25.0]), np.array([0.4, -0.7])),
                        lambda x: np.diag([1.0, 25.0]), np.zeros(2),
                        np.full(2, -3.0), np.full(2, 3.0), dict(steps=12)),
    "lying_gradient": (_liar, lambda x: 2.0 * np.eye(2), np.array([1.0, -1.5]),
                       np.full(2, -4.0), np.full(2, 4.0), dict(steps=30)),
    "box_pin": (_far, lambda x: 2.0 * np.eye(2), np.zeros(2), np.full(2, -1.0),
                np.full(2, 1.0), dict(steps=20, radius=0.5)),
    "indefinite": (lambda x: (float(np.sin(x[0]) * np.cosh(x[1])),
                              np.array([np.cos(x[0]) * np.cosh(x[1]),
                                        np.sin(x[0]) * np.sinh(x[1])])),
                   lambda x: np.array([[-np.sin(x[0]) * np.cosh(x[1]),
                                        np.cos(x[0]) * np.sinh(x[1])],
                                       [np.cos(x[0]) * np.sinh(x[1]),
                                        np.sin(x[0]) * np.cosh(x[1])]]),
                   np.array([0.3, 0.2]), np.full(2, -2.0), np.full(2, 2.0),
                   dict(steps=15)),
    "nonfinite_hessian": (_quadratic(np.eye(3), np.array([1.0, 2.0, -1.0])),
                          lambda x: np.full((3, 3), np.nan), np.zeros(3),
                          np.full(3, -5.0), np.full(3, 5.0), dict(steps=8)),
}


def _same_tr(got, want):
    best, theta, trace, g0, st = got
    jbest, jtheta, jtrace, jg0, jst = want
    assert best == jbest and trace == jtrace
    np.testing.assert_array_equal(theta, jtheta)
    np.testing.assert_array_equal(g0, jg0)
    assert st == jst


@pytest.mark.parametrize("case", list(TR_CASES))
def test_trust_region_descent_matches_reference(case):
    vg, hess, x0, lo, hi, kw = TR_CASES[case]
    got = S._trust_region_descent(vg, hess, x0, lo, hi, **kw)
    _same_tr(got, JS._trust_region_descent(vg, hess, x0, lo, hi, **kw))
    assert got[0] <= got[2][0]          # never worse than the seed


@pytest.mark.parametrize("seed", range(4))
def test_tr_step_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 2 + seed
    M = rng.normal(size=(n, n))
    g = rng.normal(size=n)
    for H in (M @ M.T, M + M.T, np.zeros((n, n)), np.full((n, n), np.inf)):
        for radius in (1e-3, 0.5, 10.0):
            np.testing.assert_array_equal(S._tr_step(H, g, radius),
                                          JS._tr_step(H, g, radius))
    np.testing.assert_array_equal(S._tr_step(M, np.zeros(n), 0.5),
                                  JS._tr_step(M, np.zeros(n), 0.5))


def test_trust_region_descent_exact_quadratic_converges():
    vg, hess, x0, lo, hi, kw = TR_CASES["exact_quadratic"]
    best, theta, trace, g0, st = S._trust_region_descent(vg, hess, x0, lo, hi, **kw)
    assert best == trace[-1] <= trace[0]
    assert np.allclose(theta, [0.4, -0.7], atol=1e-6)
    assert best == pytest.approx(0.0, abs=1e-10)
    assert st["rejected"] == 0 and st["accepted"] >= 1
    assert np.allclose(g0, -np.diag([1.0, 25.0]) @ np.array([0.4, -0.7]))


def test_trust_region_rejects_lying_gradient_and_shrinks_radius():
    vg, hess, x0, lo, hi, kw = TR_CASES["lying_gradient"]
    best, theta, trace, _, st = S._trust_region_descent(vg, hess, x0, lo, hi, **kw)
    assert st["accepted"] == 0 and st["rejected"] >= 3
    rt = st["radius_trace"]
    assert len(rt) == st["rejected"]
    assert all(b < a for a, b in zip(rt, rt[1:]))
    assert st["stopped_early"] and st["final_radius"] < 1e-5
    assert best == trace[0] and len(trace) == 1
    assert np.array_equal(theta, x0)


def test_trust_region_pins_against_box():
    vg, hess, x0, lo, hi, kw = TR_CASES["box_pin"]
    best, theta, trace, _, st = S._trust_region_descent(vg, hess, x0, lo, hi, **kw)
    assert np.allclose(theta, 1.0)
    assert st["stopped_early"]
    assert best == pytest.approx(2 * 81.0)


def _sep(v):
    return (v["a"] - 7) ** 2 + (v["b"] - 3) ** 2


def _capped(v):
    return float("inf") if v["a"] + v["b"] > 9 else -(v["a"] + v["b"])


INT_CASES = {
    "separable": (_sep, {"a": 2, "b": 10}, {"a": 1, "b": 1}, {"a": 16, "b": 16}, {}),
    "bounded_infeasible": (_capped, {"a": 4, "b": 4}, {"a": 1, "b": 1},
                           {"a": 6, "b": 6}, {}),
    "one_sweep": (_sep, {"a": 1, "b": 1}, {"a": 1, "b": 1}, {"a": 16, "b": 16},
                  dict(max_sweeps=1, max_steps=3)),
}


@pytest.mark.parametrize("case", list(INT_CASES))
def test_coordinate_int_search_matches_reference(case):
    score, x0, lo, hi, kw = INT_CASES[case]
    calls = []

    def counted(v):
        calls.append(1)
        return score(v)

    got = S._coordinate_int_search(x0, lo, hi, counted, **kw)
    assert got == JS._coordinate_int_search(x0, lo, hi, score, **kw)
    assert got[2]["n_scored"] == len(calls)        # memoized: never re-scored
    assert all(lo[k] <= v <= hi[k] for k, v in got[0].items())


def test_coordinate_int_search_optima():
    best, val, st = S._coordinate_int_search({"a": 2, "b": 10}, {"a": 1, "b": 1},
                                             {"a": 16, "b": 16}, _sep)
    assert best == {"a": 7, "b": 3} and val == 0.0 and st["n_sweeps"] >= 2
    best, val, _ = S._coordinate_int_search({"a": 4, "b": 4}, {"a": 1, "b": 1},
                                            {"a": 6, "b": 6}, _capped)
    assert best["a"] + best["b"] == 9 and val == -9.0


@pytest.mark.parametrize("steps", [0, 1, 7])
def test_projected_descent_matches_reference(steps):
    A = np.array([[3.0, 0.5], [0.5, 1.0]])
    vg = _quadratic(A, np.array([2.0, -3.0]))
    lo, hi = np.array([-1.0, -2.5]), np.array([1.5, 2.0])
    theta0 = np.array([0.2, 0.1])
    got = S._projected_descent(vg, theta0, lo, hi, steps, 0.3)
    with engine_x64():
        want = JS._projected_descent(vg, jnp.asarray(theta0), jnp.asarray(lo),
                                     jnp.asarray(hi), steps, 0.3)
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[3], want[3])


def test_small_helpers_match_reference():
    for v, extra, lo in ((3.2, None, 1), (0.4, None, 1), (7.0, 9.0, 1), (2.5, 2.0, 3),
                         (0.0, None, 0)):
        assert S._int_neighbors(v, extra, lo) == JS._int_neighbors(v, extra, lo)
    m = {"energy_j": np.array([[1.5, 2.0]]), "latency_s": np.array([[3.0, 0.25]]),
         "power_w": np.array([[7.0, 8.0]])}
    for obj in ("edp", "power_w"):
        np.testing.assert_array_equal(S._objective_value(m, obj), JS._objective_value(m, obj))
    w = np.array([0.2, 0.3, 0.5])
    for vals in ([2.5], [1e-12, 3e-9, 7e-10]):
        assert S._combined_value(vals, w[:len(vals)]) == JS._combined_value(vals, w[:len(vals)])
    wls = [CNN_WORKLOADS[n]() for n in ("LeNet5", "ResNet18")]
    jwls = [JCNN[n]() for n in ("LeNet5", "ResNet18")]
    for weights in (None, (3.0, 1.0)):
        got, want = S._as_workload_batch(wls, weights), JS._as_workload_batch(jwls, weights)
        assert [x.name for x in got[0]] == [x.name for x in want[0]]
        np.testing.assert_array_equal(got[1], want[1])
    assert S._as_workload_batch(wls[0], None)[1].tolist() == [1.0]
    for bad, match in (([], "at least one"), ((1.0,), "weights"), ((1.0, -1.0), "positive")):
        with pytest.raises(ValueError, match=match):
            S._as_workload_batch(wls if bad != [] else [], bad if bad != [] else None)
    with pytest.raises(TypeError):
        S._as_workload_batch([wls[0], "LeNet5"], None)
    (_, _, front, _), _ = _setup()
    for obj in ("edp", "power_w", "epb_j"):      # on the same front object
        np.testing.assert_array_equal(S._front_objective(front, obj),
                                      JS._front_objective(front, obj))


def test_check_objective_and_axes():
    assert S.DEFAULT_REFINE_AXES == JS.DEFAULT_REFINE_AXES
    assert S.ACCEL_REFINE_AXES == JS.ACCEL_REFINE_AXES
    for name in ("refine_continuous", "refine_front_point", "DEFAULT_REFINE_AXES",
                 "refine_codesign", "refine_trust_region", "refine_front",
                 "ACCEL_REFINE_AXES"):
        assert name in S.__all__
    from repro_torch import core
    assert core.refine_codesign is S.refine_codesign
    for where, vocab in (("a", ("x", "y")), ("b", ())):
        S._check_objective("edp", vocab, where)
        S._check_objective("edp", vocab, where)
        with pytest.raises(ValueError) as e:
            S._check_objective("nope", vocab, where)
        with pytest.raises(ValueError) as je:
            JS._check_objective("nope", vocab, where)
        assert str(e.value) == str(je.value)


# ---------------------------------------------------------------------------
# refine_continuous / refine_front_point
# ---------------------------------------------------------------------------


def _same_continuous(r, jr, ctx):
    for k in ("topology", "objective", "refine_axes"):
        assert r[k] == jr[k], (ctx, k)
    _close(r["loss_trace"], jr["loss_trace"], (ctx, "trace"))
    for blk in ("start", "refined", "metrics"):
        assert sorted(r[blk]) == sorted(jr[blk]), (ctx, blk)
        _close([r[blk][k] for k in jr[blk]], list(jr[blk].values()), (ctx, blk))
    _close([r["start_value"], r["refined_value"]], [jr["start_value"], jr["refined_value"]],
           ctx)
    _close(r["improvement"], jr["improvement"], ctx, rtol=1e-7)


def test_refine_continuous_matches_reference_and_respects_bounds():
    t, jt = CNN_WORKLOADS["ResNet18"]().traffic(), JCNN["ResNet18"]().traffic()
    r = S.refine_continuous("trine", {"n_gateways": 32}, t, steps=25, lr=0.1, span=4.0,
                            device=CPU)
    with engine_x64():
        jr = JS.refine_continuous("trine", {"n_gateways": 32}, jt, steps=25, lr=0.1,
                                  span=4.0)
    _same_continuous(r, jr, "trine/ResNet18")
    assert r["refined_value"] <= r["start_value"]
    for nm, v in r["refined"].items():
        lo, hi = r["start"][nm] / 4.0, r["start"][nm] * 4.0
        assert lo <= v <= hi, nm
    assert set(r["metrics"]) >= {"latency_s", "energy_j", "power_w"}


@pytest.mark.parametrize("objective", ["power_w", "latency_s"])
def test_refine_continuous_metric_objectives_match_reference(objective):
    t, jt = CNN_WORKLOADS["LeNet5"]().traffic(), JCNN["LeNet5"]().traffic()
    r = S.refine_continuous("tree", {"n_lambda": 4}, t, objective=objective, steps=6,
                            device=CPU)
    with engine_x64():
        jr = JS.refine_continuous("tree", {"n_lambda": 4}, jt, objective=objective, steps=6)
    _same_continuous(r, jr, objective)
    assert r["objective"] == objective


def test_refine_front_point_from_pareto_search_matches_reference():
    t, jt = CNN_WORKLOADS["ResNet18"]().traffic(), JCNN["ResNet18"]().traffic()
    axes = dict(n_gateways=(16, 32), n_lambda=(4, 8))
    front = S.pareto_search(t, topologies=("trine", "tree"), device=CPU, **axes)
    jfront = JS.pareto_search(jt, topologies=("trine", "tree"), **axes)
    np.testing.assert_array_equal(front.indices, jfront.indices)
    spec = grid_spec(("trine", "tree"), **axes)
    r = S.refine_front_point(spec, t, int(front.indices[0]), steps=10, lr=0.1, device=CPU)
    with engine_x64():
        jr = JS.refine_front_point(j_grid_spec(("trine", "tree"), **axes), jt,
                                   int(jfront.indices[0]), steps=10, lr=0.1)
    _same_continuous(r, jr, "front point")
    assert r["refined_value"] <= r["start_value"]
    assert r["topology"] in ("trine", "tree")


def test_refine_continuous_metrics_describe_clipped_design():
    """With a tight box the projection is active at the end of the descent;
    the reported metrics are those of the reported (clipped) design."""
    t, jt = CNN_WORKLOADS["LeNet5"]().traffic(), JCNN["LeNet5"]().traffic()
    axes = ("modulation_rate_bps", "mem_bw_bytes_per_s")
    probe = S.refine_continuous("trine", {}, t, refine_axes=axes, steps=0, device=CPU)
    tight = {nm: (v * 0.999, v * 1.001) for nm, v in probe["start"].items()}
    r = S.refine_continuous("trine", {}, t, refine_axes=axes, steps=10, lr=0.5,
                            bounds=tight, device=CPU)
    with engine_x64():
        jr = JS.refine_continuous("trine", {}, jt, refine_axes=axes, steps=10, lr=0.5,
                                  bounds=tight)
    _same_continuous(r, jr, "tight box")
    assert r["refined_value"] <= r["start_value"] * (1 + 1e-12)
    # float64 log-space projection: a pinned axis sits on its bound to rounding
    at_bound = [nm for nm, v in r["refined"].items()
                if min(abs(v - tight[nm][0]), abs(v - tight[nm][1])) <= 1e-12 * v]
    assert at_bound, r["refined"]
    r2 = S.refine_continuous("trine", dict(r["refined"]), t, refine_axes=axes, steps=0,
                             device=CPU)
    for k, v in r["metrics"].items():
        assert r2["metrics"][k] == pytest.approx(v, rel=1e-9), k


def test_refine_objective_and_method_validated_eagerly():
    t = CNN_WORKLOADS["LeNet5"]().traffic()
    with pytest.raises(ValueError, match="valid objectives"):
        S.refine_continuous("trine", {}, t, objective="edp_j", device=CPU)
    (wl, mixes, front, spec), _ = _setup()
    idx = int(front.indices[0])
    with pytest.raises(ValueError, match="valid objectives"):
        S.refine_codesign(spec, mixes, wl, idx, objective="edp_j", device=CPU)
    with pytest.raises(ValueError, match="method"):
        S.refine_codesign(spec, mixes, wl, idx, method="newton", device=CPU)
    with pytest.raises(KeyError, match="accelerator refine axes"):
        S.refine_codesign(spec, mixes, wl, idx, accel_axes=("clock",), device=CPU)
    with pytest.raises(KeyError, match="unknown topology"):
        S.refine_continuous("ring", {}, t, device=CPU)
    r = S.refine_continuous("trine", {}, t, objective="power_w", steps=2, device=CPU)
    assert r["objective"] == "power_w"


def test_refiners_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    t = CNN_WORKLOADS["LeNet5"]().traffic()
    with pytest.raises(RuntimeError, match="cuda"):
        S.refine_continuous("trine", {}, t)
    (wl, mixes, front, spec), _ = _setup()
    with pytest.raises(RuntimeError, match="cuda"):
        S.refine_codesign(spec, mixes, wl, int(front.indices[0]))
    with pytest.raises(RuntimeError, match="cuda"):
        S.refine_front(front, spec, mixes, wl, top_k=1)


# ---------------------------------------------------------------------------
# the relaxed co-design loss, its gradient and Hessian against jax
# ---------------------------------------------------------------------------


def _problem(spec, mixes, idx, refine_axes):
    """cols, topology, entries, seed mix of a seed — as `refine_codesign`
    builds them (every accelerator axis relaxed)."""
    cfg = S.codesign_config_at(spec, mixes, idx)
    seed_mix = list(cfg.pop("chiplets"))
    cfg.pop("mix")
    topo = cfg.pop("topology")
    cols = dict(spec.base)
    cols.update({k: float(v) for k, v in cfg.items()})
    active = [j for j, c in enumerate(seed_mix) if c.n_units > 0]
    entries = ([("net", nm, cols[nm]) for nm in refine_axes]
               + [("units", j, float(seed_mix[j].n_units)) for j in active]
               + [("vec", j, float(seed_mix[j].vector_size)) for j in active]
               + [("mac", None, 5e9), ("slot", None, 30e-15)])
    return cols, topo, entries, seed_mix


def _jax_loss(cols, topo, entries, seed_mix, jwls, wts):
    """The reference's relaxed loss (`refine_codesign`'s closure), rebuilt
    from its own kernels; call inside engine_x64."""
    kern = J_TOPOLOGY_ARRAYS[topo]
    lcs = [{k: np.asarray(v, np.float64) for k, v in j_layer_columns(w).items()}
           for w in jwls]
    units0 = np.asarray([float(c.n_units) for c in seed_mix])
    vec0 = np.asarray([float(c.vector_size) for c in seed_mix])

    def loss_of(theta):
        x = jnp.exp(theta)
        total = 0.0
        for wt, lc_np in zip(wts, lcs):
            c = {k: _as_f64(v) for k, v in cols.items()}
            lc = {k: _as_f64(v) for k, v in lc_np.items()}
            units, vec = _as_f64(units0), _as_f64(vec0)
            mac, slot = _as_f64(5e9), _as_f64(30e-15)
            for i, (kind, key, _) in enumerate(entries):
                if kind == "net":
                    c[key] = x[i]
                elif kind == "units":
                    units = units.at[key].set(x[i])
                elif kind == "vec":
                    vec = vec.at[key].set(x[i])
                elif kind == "mac":
                    mac = x[i]
                else:
                    slot = x[i]
            fields = kern(c, xp=jnp)
            nets1 = {k: jnp.reshape(fields[k], (1,)) for k in J_MODEL_FIELDS}
            dev1 = {k: jnp.reshape(c[k], (1,)) for k in J_DEV_FIELDS}
            mem_bw1 = jnp.reshape(c["n_mem_chiplets"] * c["mem_bw_bytes_per_s"], (1,))
            m = j_accel_mix_math({"n_units": units, "vector_size": vec}, None, lc, nets1,
                                 dev1, mem_bw1, mac, slot, _as_f64(16.0), adaptive=True,
                                 relaxed=True)
            total = total + float(wt) * (jnp.log(m["energy_j"][0])
                                         + jnp.log(m["latency_s"][0]))
        return total

    return loss_of


@pytest.mark.parametrize("case", ["one_workload", "three_workloads"])
def test_relaxed_loss_gradient_and_hessian_match_jax(case):
    (wl, mixes, front, spec), _ = _setup()
    names = ["LeNet5"] if case == "one_workload" else ["LeNet5", "ResNet18", "VGG16"]
    axes = S.DEFAULT_REFINE_AXES if case == "one_workload" else TR_AXES
    wts = np.full(len(names), 1.0 / len(names))
    for i in _edp_order()[:1]:
        cols, topo, entries, seed_mix = _problem(spec, mixes, int(front.indices[i]), axes)
        theta = np.log(np.asarray([e[2] for e in entries]))
        loss = S._relaxed_loss(cols, topo, entries, seed_mix,
                               [CNN_WORKLOADS[n]() for n in names], wts, "edp", 5e9, 30e-15,
                               16, True, TorchNS(CPU))
        v, g = S._value_and_grad(loss, torch.device(CPU))(theta)
        Hm = S._hessian(loss, torch.device(CPU))(theta)
        jmix = [JChipletSpec(c.n_units, c.vector_size) for c in seed_mix]
        with engine_x64():
            jloss = _jax_loss(cols, topo, entries, jmix, [JCNN[n]() for n in names], wts)
            jv, jg = jax.jit(jax.value_and_grad(jloss))(_as_f64(theta))
            jH = np.asarray(jax.jit(jax.hessian(jloss))(_as_f64(theta)))
        assert np.all(np.isfinite(Hm)) and np.all(np.isfinite(g))
        ctx = (case, int(front.indices[i]))
        _close(v, float(jv), ctx, rtol=HESS_RTOL)
        _close_vec(g, np.asarray(jg), ctx, rtol=HESS_RTOL)
        # entries of the Hessian that are zero up to rounding compare
        # against the matrix's scale
        np.testing.assert_allclose(Hm, jH, rtol=HESS_RTOL,
                                   atol=HESS_RTOL * np.abs(jH).max(), err_msg=str(ctx))
        np.testing.assert_allclose(Hm, Hm.T, rtol=HESS_RTOL,
                                   atol=HESS_RTOL * np.abs(Hm).max(), err_msg=str(ctx))


# ---------------------------------------------------------------------------
# refine_codesign / refine_trust_region / refine_front against the reference
# ---------------------------------------------------------------------------


def _both(method, seeds, names=("LeNet5",), **kw):
    """The port's and the x64 reference's refine_codesign on the setup's
    seeds (front rows `seeds`)."""
    (wl, mixes, front, spec), (jwl, jmixes, jfront, jspec) = _setup()
    wls = [CNN_WORKLOADS[n]() for n in names]
    jwls = [JCNN[n]() for n in names]
    out = []
    for i in seeds:
        idx = int(front.indices[i])
        r = S.refine_codesign(spec, mixes, wls if len(wls) > 1 else wls[0], idx,
                              method=method, device=CPU, **kw)
        with engine_x64():
            jr = JS.refine_codesign(jspec, jmixes, jwls if len(jwls) > 1 else jwls[0], idx,
                                    method=method, **kw)
        _same_codesign(r, jr, method)
        out.append(r)
    return out, spec, wls


def _edp_order():
    (_, _, front, _), _ = _setup()
    return np.argsort(front.points[:, 0] * front.points[:, 1])


def test_refine_codesign_first_order_matches_reference_and_rescores_exact():
    (r,), spec, wls = _both("first_order", [0], steps=8)
    cfg = r["refined"]["config"]
    for c in cfg["chiplets"]:
        assert isinstance(c.n_units, int) and isinstance(c.vector_size, int)
        assert c.vector_size >= 1 and c.n_units >= 0
    assert any(c.n_units > 0 for c in cfg["chiplets"])
    for nm in ("n_gateways", "n_lambda"):
        assert cfg[nm] == float(int(cfg[nm]))
    _rescore(r, spec, wls)


def test_refine_codesign_first_order_improves_at_least_one_seed():
    results, _, _ = _both("first_order", _edp_order()[:3], steps=12)
    for r in results:
        assert r["refined"]["value"] <= r["seed"]["value"] and r["improvement"] >= 0.0
        assert set(r["sensitivity"]) >= {"modulation_rate_bps", "mac_rate_hz"}
    assert any(r["improvement"] > 0 for r in results)


def test_refine_codesign_trust_region_matches_reference_and_rescores_exact():
    (r,), spec, wls = _both("trust_region", [0], steps=6, refine_axes=TR_AXES)
    assert r["method"] == "trust_region"
    assert r["refined"]["value"] <= r["seed"]["value"] and r["improvement"] >= 0.0
    st = r["tr_stats"]
    assert st["accepted"] + st["rejected"] == len(st["radius_trace"]) <= 6
    cfg = r["refined"]["config"]
    assert any(c.n_units > 0 for c in cfg["chiplets"])
    assert cfg["n_gateways"] == float(int(cfg["n_gateways"]))
    _rescore(r, spec, wls)


def test_refine_codesign_tr_line_search_dominates_snap():
    results, _, _ = _both("trust_region", _edp_order()[:3], steps=4, refine_axes=TR_AXES)
    for r in results:
        assert r["refined"]["value"] <= r["seed"]["value"]
        assert r["line_search"]["value"] <= r["line_search"]["snap_value"]
    assert any(r["line_search"]["n_scored"] > 1 for r in results)


@pytest.mark.parametrize("method", ["first_order", "trust_region"])
def test_refine_codesign_multiworkload_geomean_matches_reference(method):
    (r,), spec, wls = _both(method, [0], names=("LeNet5", "ResNet18"), steps=4,
                            refine_axes=TR_AXES, weights=(3.0, 1.0))
    assert r["workloads"] == ["LeNet5", "ResNet18"]
    assert r["weights"] == pytest.approx([0.75, 0.25])
    for blk in (r["seed"], r["refined"]):
        edps = [m["energy_j"] * m["latency_s"] for m in blk["per_workload"]]
        geo = float(np.exp(0.75 * np.log(edps[0]) + 0.25 * np.log(edps[1])))
        assert blk["value"] == pytest.approx(geo, rel=1e-12)
    _rescore(r, spec, wls)
    (_, mixes, front, spec), _ = _setup()
    with pytest.raises(ValueError, match="weights"):
        S.refine_codesign(spec, mixes, wls, int(front.indices[0]), weights=(1.0,),
                          device=CPU)
    with pytest.raises(ValueError, match="positive"):
        S.refine_codesign(spec, mixes, wls, int(front.indices[0]), weights=(1.0, -1.0),
                          device=CPU)


def test_refine_codesign_three_workloads_first_order_matches_reference():
    """Three workloads, first order; the trust-region engine on a
    three-CNN batch is held to the reference in
    `test_torch_pareto_bench_refine_sections_match_reference`, and its
    relaxed loss, gradient and Hessian in
    `test_relaxed_loss_gradient_and_hessian_match_jax`."""
    _both("first_order", _edp_order()[:1], names=("LeNet5", "MobileNetV2", "EfficientNetB0"),
          steps=6)


def test_refine_codesign_candidate_cap_matches_reference():
    """max_candidates below the cross product: the nearest-rounded design
    plus single-axis flips, as the reference builds them."""
    _both("first_order", _edp_order()[:2], steps=6, max_candidates=4,
          refine_axes=TR_AXES)


@pytest.mark.parametrize("method", ["first_order", "trust_region"])
def test_refine_front_matches_reference_and_dominates_seed(method):
    (wl, mixes, front, spec), (jwl, jmixes, jfront, jspec) = _setup()
    kw = dict(top_k=3, steps=6) if method == "first_order" else dict(
        top_k=2, steps=4, refine_axes=TR_AXES)
    out = S.refine_front(front, spec, mixes, wl, method=method, device=CPU, **kw)
    with engine_x64():
        jout = JS.refine_front(jfront, jspec, jmixes, jwl, method=method, **kw)
    for r, jr in zip(out["results"], jout["results"]):
        _same_codesign(r, jr, f"refine_front/{method}")
    assert len(out["results"]) == len(jout["results"])
    np.testing.assert_array_equal(out["front"].indices, jout["front"].indices)
    _close(out["front"].points, jout["front"].points, method)
    assert out["n_improved"] == jout["n_improved"]
    assert list(out["sensitivity"]) == list(jout["sensitivity"])
    _close_vec(list(out["sensitivity"].values()), list(jout["sensitivity"].values()), method)
    merged, seed = out["front"], out["seed_front"]
    union = np.concatenate([merged.points, seed.points])
    seed_on_union = S.pareto_mask_reference(union)[merged.size:]
    seed_present = np.array([bool((merged.points == p).all(-1).any()) for p in seed.points])
    assert np.all(~seed_on_union | seed_present)
    assert len(out["configs"]) == merged.size
    for cfg, jcfg in zip(out["configs"], jout["configs"]):
        assert cfg["topology"] in ("trine", "tree") and "chiplets" in cfg
        assert _chips(cfg["chiplets"]) == _chips(jcfg["chiplets"])
    assert set(out["sensitivity"]) >= {"modulation_rate_bps", "lambda_slot_energy_j"}
    with pytest.raises(ValueError, match="empty front"):
        S.refine_front(S.ParetoFront(front.objectives, front.points[:0], front.indices[:0]),
                       spec, mixes, wl, device=CPU)


def test_first_order_deviation_from_the_float32_reference():
    """Recorded deviation: the reference's first-order path runs at jax's
    default precision (float32).  On this LeNet5 seed the float32
    reference snaps to another integer design than the float64 one; the
    port equals the float64 reference (the design (255, 9), (127, 48)),
    and the float32 loss trace stays within float32 rounding of the
    port's."""
    (wl, mixes, front, spec), (jwl, jmixes, jfront, jspec) = _setup()
    idx = int(front.indices[0])
    r = S.refine_codesign(spec, mixes, wl, idx, steps=8, device=CPU)
    with engine_x64():
        j64 = JS.refine_codesign(jspec, jmixes, jwl, idx, steps=8)
    with jax.enable_x64(False):
        j32 = JS.refine_codesign(jspec, jmixes, jwl, idx, steps=8)
    assert _chips(r["refined"]["chiplets"]) == _chips(j64["refined"]["chiplets"]) \
        == [(255, 9), (127, 48)]
    assert _chips(j32["refined"]["chiplets"]) != _chips(r["refined"]["chiplets"])
    np.testing.assert_allclose(j32["loss_trace"], r["loss_trace"], rtol=1e-5)
    # both designs are feasible integer designs, each never worse than the seed
    for res in (r, j32):
        assert res["refined"]["value"] <= res["seed"]["value"]


# ---------------------------------------------------------------------------
# the analytic roofline
# ---------------------------------------------------------------------------


def _stats(mod):
    return mod.HloStats(dot_flops=1.7e10, dot_bytes=3.1e8, op_result_bytes=9.0e8,
                        collective_bytes=25.8e6, collective_op_bytes={"all-reduce": 25.8e6},
                        collective_op_counts={"all-reduce": 121, "all-gather": 4}, max_trip=1,
                        collective_bytes_raw=51.6e6)


def test_roofline_matches_reference():
    assert (H.PEAK_FLOPS, H.HBM_BW, H.ICI_BW) == (JH.PEAK_FLOPS, JH.HBM_BW, JH.ICI_BW)
    (wl, mixes, front, spec), (jwl, jmixes, jfront, jspec) = _setup()
    fab = FAB.fabrics_from_front(front, spec, mixes=mixes, max_fabrics=1)[0]
    jfab = JFAB.fabrics_from_front(jfront, jspec, mixes=jmixes, max_fabrics=1)[0]
    assert _stats(H).to_json() == _stats(JH).to_json()
    pairs = [(None, None), ("metallic_ici", "metallic_ici"), ("trine_siph", "trine_siph"),
             (FAB.metallic_ici(), JFAB.metallic_ici()), (fab, jfab)]
    for cost in ({}, {"flops": 2.0e10, "bytes accessed": 5.5e8}):
        for io in (0.0, 2.15e9):
            for f, jf in pairs:
                got = H.roofline(_stats(H), cost, 1.5e10, io_bytes=io, fabric=f)
                want = JH.roofline(_stats(JH), cost, 1.5e10, io_bytes=io, fabric=jf)
                assert got.to_json() == want.to_json(), (f, cost, io)
    zero = H.HloStats(0.0, 0.0, 0.0, 0.0, {}, {}, 0)
    jzero = JH.HloStats(0.0, 0.0, 0.0, 0.0, {}, {}, 0)
    assert H.roofline(zero, {}, 1.0).to_json() == JH.roofline(jzero, {}, 1.0).to_json()
    with pytest.raises(KeyError):
        H.roofline(_stats(H), {}, 1.0, fabric="no_such_fabric")


# ---------------------------------------------------------------------------
# benchmarks/torch_pareto_bench.py's refine sections and the example
# ---------------------------------------------------------------------------


def test_torch_pareto_bench_refine_sections_match_reference():
    import benchmarks.pareto_bench as ref
    import benchmarks.torch_pareto_bench as port
    out = port.run(csv=False, smoke=True, device=CPU)
    assert "sections_left_out" not in out
    for k in ("refinement_improves", "refined_front_dominates_seed",
              "trust_region_front_dominates_first_order",
              "trust_region_rescore_bit_identical"):
        assert out["checks"][k] and k in out["required_checks"], k
    assert "refined_improves_a_seed" in out["checks"]
    assert "refined_improves_a_seed" not in out["required_checks"]
    assert out["pass"]
    # the reference functions on the same front, inside engine_x64
    jwl = JCNN["ResNet18"]()
    jmixes = ref._mix_library(True)
    jfront, jspec = JS.codesign_pareto(jwl, jmixes, topologies=ref.TOPOLOGIES,
                                       **ref.SMOKE_NET_AXES)
    best = ref._edp_argmin(jfront)
    assert out["codesign"]["best_edp_index"] == best
    with engine_x64():
        jrefine = JS.refine_front_point(jspec, jwl.traffic(), best % jspec.n, steps=8, lr=0.1)
        jrf = JS.refine_front(jfront, jspec, jmixes, jwl, top_k=3, steps=6, lr=0.1)
        # the trust-region section's best-EDP seed (its first of three)
        jtr = JS.refine_front(jfront, jspec, jmixes,
                              [jwl, JCNN["MobileNetV2"](), JCNN["EfficientNetB0"]()],
                              top_k=1, method="trust_region",
                              refine_axes=port.TR_AXES, steps=6)
    for k in ("start_value", "refined_value"):
        _close(out["refine"][k], jrefine[k], k)
    assert out["refine"]["refine_axes"] == jrefine["refine_axes"]
    _close(list(out["refine"]["refined"].values()), list(jrefine["refined"].values()), "refine")
    fo = out["refined_front"]
    assert fo["seeds_refined"] == 3 and fo["seed_front_size"] == jfront.size
    assert fo["merged_front_size"] == jrf["front"].size
    assert fo["n_improved"] == jrf["n_improved"]
    assert fo["n_candidates"] == [r["n_candidates"] for r in jrf["results"]]
    _close(fo["improvements"], [r["improvement"] for r in jrf["results"]], "fo", rtol=1e-7)
    _close_vec(list(fo["sensitivity"].values()), list(jrf["sensitivity"].values()), "fo sens")
    tr = out["trust_region_front"]
    assert tr["workloads"] == ["ResNet18", "MobileNetV2", "EfficientNetB0"]
    assert tr["seeds_refined"] == 3
    (jr,) = jtr["results"]
    assert (tr["tr_accepted"][0], tr["tr_rejected"][0]) == \
        (jr["tr_stats"]["accepted"], jr["tr_stats"]["rejected"])
    assert tr["line_search"][0]["n_scored"] == jr["line_search"]["n_scored"]
    _close(tr["line_search"][0]["value"], jr["line_search"]["value"], "tr line search")
    _close(tr["improvements"][0], jr["improvement"], "tr", rtol=1e-7)


def test_example_torch_photonic_design_space_smoke():
    env = dict(os.environ, REPRO_SMOKE="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    p = subprocess.run([sys.executable, str(ROOT / "examples/torch_photonic_design_space.py"),
                        "--device", "cpu"], env=env, capture_output=True, text=True,
                       timeout=240, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-4000:]
    for line in ("K-sweep: energy-delay product", "WDM sweep:", "Device sensitivity:",
                 "Full design-space search:", "Streaming Pareto search:",
                 "Gradient refinement (autograd through the", "Co-design search (ResNet18):",
                 "Co-design refinement:", "refined best as Fabric:",
                 "Six-CNN joint refinement", "six-CNN best as Fabric:",
                 "Fabric what-if (yi_34b decode cell):"):
        assert line in p.stdout, line
    assert "jax" not in p.stdout
