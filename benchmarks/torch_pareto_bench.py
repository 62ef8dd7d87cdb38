"""Pareto/co-design search benchmark: chunked streaming vs monolithic vs
scalar evaluation, with exact front verification, then the refinement
engines on the co-design front.

Five sections:

  * network grid — the pure interposer-network design space (topology x
    gateways x lambda x memory BW x modulation x geometry x device corner):
    monolithic `sweep` vs `sweep_chunked` streaming vs the scalar dataclass
    loop (sampled), plus streaming-vs-monolithic Pareto front equality.
  * streaming pipeline — the same streaming engine timed in its three
    execution modes on a >= 1e6-point grid (full mode): host-serial
    (per-chunk numpy materialization, prefetch 0), device-serial (device
    mixed-radix decode, prefetch 0), and device-pipelined (decode + a
    depth-2 prefetch queue overlapping host folds with device compute).
    All three must return bit-identical MinReducer states; the pipelined
    path must beat host-serial by >= 1.2x in full mode (reported but
    exempted in smoke, where per-chunk dispatch dominates the tiny grid).
  * co-design grid — the same network axes crossed with a chiplet-mix
    library through the accelerator grid kernel: >= 1e6 joint design
    points in full mode, evaluated chunked under bounded memory, with the
    extracted (latency, energy, power) front verified *exactly* against the
    full point cloud (every front point mutually non-dominated by O(k^2)
    brute force; every grid point dominated by or equal to a front member —
    with transitive dominance this is equivalent to the O(n^2) pairwise
    reference, but streams in O(n * front) blocks on the device).  Smoke
    mode additionally runs the literal O(n^2) brute force.  The best-EDP
    front point is then refined through its continuous network columns
    (`refine_front_point`, autograd): its EDP must not get worse.
  * refined front — `refine_codesign` on the top-3 best-EDP frontier seeds:
    joint relaxed gradient descent over accelerator + network axes, rounded
    back to feasible integer designs and exactly re-scored, merged into the
    seed front.  The merged front must weakly dominate the seed front
    (required check, verified against `pareto_mask_reference`); in full mode
    at least one seed must strictly improve (exempted in smoke, where the
    shortened descent may not escape an exactly-scored seed).
  * trust-region refined front — the same seeds refined with
    `method="trust_region"` (second-order log-space trust-region descent +
    coordinate-wise integer line search, n_gateways added to the discrete
    axes) jointly against a three-CNN workload batch (weighted-geomean EDP).
    Two required checks in BOTH modes: the trust-region front must weakly
    dominate the first-order refined front (merging unions the point sets,
    so this holds by construction — the gate re-verifies with the O(n^2)
    brute-force reference that the merge machinery lost nothing), and every
    trust-region design's per-workload metrics must re-score bit-identically
    through a standalone `evaluate_accelerator_grid` call on the same device.

Acceptance bars (recorded in the artifact): chunked evaluation throughput
within 1.5x of the monolithic call (2x in smoke), batched >= 20x the scalar
loop (2x in smoke), fronts exactly equal between the streaming and
monolithic paths.

The PyTorch port's counterpart of `benchmarks/pareto_bench.py`, from
`repro_torch.core` on ``device`` (default "cuda"; the scalar loop and the
descent loops on the host), without the reference's front plot.  Writes
`artifacts/torch_pareto_bench.json`.  REPRO_SMOKE=1 shrinks both grids and
the descents.

    PYTHONPATH=src python benchmarks/torch_pareto_bench.py [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import resource
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.core import CNN_WORKLOADS, ChipletSpec
from repro_torch.core.accelerator import CodesignChunk, evaluate_accelerator_grid
from repro_torch.core.power import evaluate_network
from repro_torch.core.search import (
    OBJECTIVES,
    _front_of,
    codesign_pareto,
    merge_fronts,
    pareto_front,
    pareto_mask_reference,
    pareto_search,
    refine_front,
    refine_front_point,
)
from repro_torch.core.sweep import (
    ChunkReducer,
    MinReducer,
    _network_columns_arrays,
    build_grid,
    grid_spec,
    network_columns_device,
    sweep,
    sweep_chunked,
)
from repro_torch.core.topology import TOPOLOGIES as TOPOLOGY_FACTORIES
from repro_torch.env import smoke_mode

ARTIFACTS = Path(__file__).resolve().parent / "artifacts"

TOPOLOGIES = ("sprint", "spacx", "tree", "trine")

# 15 * 6 * 6 * 4 * 4 * 4 = 34560 per topology; x4 topologies = 138240
FULL_NET_AXES = dict(
    n_gateways=tuple(range(8, 68, 4)),
    n_lambda=(2, 4, 8, 12, 16, 24),
    mem_bw_bytes_per_s=(25e9, 50e9, 75e9, 100e9, 150e9, 200e9),
    modulation_rate_bps=(8e9, 10e9, 12e9, 16e9),
    interposer_side_cm=(2.0, 3.0, 4.0, 5.0),
)
FULL_NET_AXES["mzi.insertion_loss_db"] = (0.5, 1.0, 1.5, 2.0)

# big enough that one call amortizes dispatch (the throughput bars compare
# steady-state paths, not fixed overheads), small enough for CI
SMOKE_NET_AXES = dict(
    n_gateways=(8, 16, 32, 64),
    n_lambda=(4, 8, 16),
    mem_bw_bytes_per_s=(50e9, 100e9, 200e9),
    modulation_rate_bps=(10e9, 12e9),
)

# extra axis for the pipeline section: 138240 x 8 = 1,105,920 streaming rows
PIPE_EXTRA_AXIS = dict(n_mem_chiplets=(2, 3, 4, 6, 8, 12, 16, 24))

# the device-pipelined streaming path must beat the host-serial streaming
# path by this factor on the full-mode (>= 1e6 point) grid
PIPELINE_SPEEDUP_BAR = 1.2

# the trust-region section's extra workloads and refined network axes
TR_WORKLOADS = ("MobileNetV2", "EfficientNetB0")
TR_AXES = ("modulation_rate_bps", "mem_bw_bytes_per_s", "interposer_side_cm",
           "mzi.insertion_loss_db", "n_gateways")


def _mix_library(smoke: bool):
    """Chiplet-mix axis of the co-design grid (x8 in full mode -> the
    138240-network grid becomes a 1,105,920-point joint space)."""
    C = ChipletSpec
    mixes = [
        [C(512, 32)],                                      # CrossLight homog.
        [C(512, 9), C(512, 27), C(512, 49), C(512, 128)],  # paper Fig. 5 mix
        [C(1024, 16)],
        [C(256, 9), C(256, 49)],
        [C(512, 9), C(512, 128)],
        [C(256, 16), C(256, 64), C(256, 256)],
        [C(2048, 8)],
        [C(384, 27), C(384, 81), C(256, 243)],
    ]
    return mixes[:3] if smoke else mixes


class _NullReducer(ChunkReducer):
    """Counts rows; used to time pure streaming evaluation throughput."""

    def step(self, carry, chunk):
        return (carry or 0) + (chunk.stop - chunk.start)


def _best_of(fn, repeats: int = 3):
    """(best wall seconds, last result) — damps timer noise."""
    best, out = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def verify_front_exact(front, points: np.ndarray, device="cuda",
                       block: int = 65536) -> bool:
    """Exact front verification against the full point cloud, streamed:
    (a) front members are mutually non-dominated (O(k^2) numpy brute
    force), and (b) every point is dominated by, or exactly equal to, a
    front member (the definition, compared blockwise on `device`).  By
    transitivity of dominance this is equivalent to the O(n^2) pairwise
    brute-force reference."""
    fp = front.points
    if not pareto_mask_reference(fp).all():
        return False
    dev = require_device(device)
    f = torch.as_tensor(fp, device=dev)[None]                  # (1, k, m)
    rows = max(1, min(block, (1 << 24) // max(1, fp.shape[0])))
    for s in range(0, points.shape[0], rows):
        p = torch.as_tensor(points[s:s + rows], device=dev)[:, None]
        le = (f <= p).all(-1)
        ne = (f != p).any(-1)
        if not bool(((le & ne) | ~ne).any(1).all()):
            return False
    return True


def _scalar_sample_cps(traffic, grid, sample: int = 96) -> float:
    """configs/sec of the scalar dataclass loop on a strided grid sample."""
    idx = np.linspace(0, grid.n - 1, num=min(sample, grid.n)).astype(int)
    t0 = time.perf_counter()
    for i in idx:
        p = grid.row_params(int(i))
        d = grid.row_devices(int(i))
        name = grid.row_topology(int(i))
        if name == "trine":
            k = int(grid.cols["n_subnetworks"][i])
            net = TOPOLOGY_FACTORIES[name](p, n_subnetworks=k or None, d=d)
        else:
            net = TOPOLOGY_FACTORIES[name](p, d=d)
        evaluate_network(net, traffic, d)
    return idx.size / (time.perf_counter() - t0)


def _edp_argmin(front) -> int:
    lat = front.points[:, list(front.objectives).index("latency_s")]
    en = front.points[:, list(front.objectives).index("energy_j")]
    return int(front.indices[int(np.argmin(lat * en))])


def _weakly_dominates(front, seed) -> bool:
    """Every point of `seed` is either still on front(front ∪ seed) and
    present verbatim in `front`, or off it — checked with the O(n^2)
    brute-force reference, independent of the merge machinery."""
    union = np.concatenate([front.points, seed.points])
    seed_on_union = pareto_mask_reference(union)[front.size:]
    seed_present = np.array([bool((front.points == p).all(-1).any())
                             for p in seed.points])
    return bool(np.all(~seed_on_union | seed_present))


def design_metrics(r, spec, workloads, device) -> list:
    """Per-workload exact metrics of a `refine_codesign` result's refined
    design: one standalone `evaluate_accelerator_grid` call per workload on
    its reported config, on `device`."""
    cfg = dict(r["refined"]["config"])
    chips = cfg.pop("chiplets")
    cfg.pop("mix")
    topo = cfg.pop("topology")
    mac = cfg.pop("mac_rate_hz")
    slot = cfg.pop("lambda_slot_energy_j")
    c1 = {k: np.full(1, v, np.float64)
          for k, v in dict(spec.base, **cfg).items()}
    n1 = _network_columns_arrays(c1, np.zeros(1, np.int64), (topo,))
    mbw = c1["n_mem_chiplets"] * c1["mem_bw_bytes_per_s"]
    return [{k: float(v[0, 0]) for k, v in evaluate_accelerator_grid(
                w, [chips], n1, c1, mbw, mac_rate_hz=mac,
                lambda_slot_energy_j=slot, device=device).items()}
            for w in workloads]


def _rescore_exact(r, spec, workloads, device) -> bool:
    """A refined design's per-workload metrics equal, bit for bit, a
    standalone evaluation of its reported config on the same device."""
    return design_metrics(r, spec, workloads, device) == r["refined"]["per_workload"]


def run(csv: bool = True, smoke: bool = None, device="cuda") -> dict:
    if smoke is None:
        smoke = smoke_mode()
    axes = SMOKE_NET_AXES if smoke else FULL_NET_AXES
    mixes = _mix_library(smoke)
    wl = CNN_WORKLOADS["ResNet18"]()
    traffic = wl.traffic()
    spec = grid_spec(TOPOLOGIES, **axes)
    n_net = spec.n
    n_joint = n_net * len(mixes)
    # smoke times the chunked machinery on a single full-grid chunk (per-
    # chunk dispatch is a fixed cost the tiny CI grid cannot amortize);
    # streaming with many chunks is exercised by the pareto_search call and
    # the co-design section either way
    net_chunk = n_net if smoke else 65536
    search_chunk = max(1, n_net // 3) if smoke else 65536
    cd_chunk = n_net if smoke else 9216  # timed path; 9216 divides 138240
    cd_search_chunk = max(1, n_net // 2) if smoke else 9216
    ratio_bar = 2.0 if smoke else 1.5
    speedup_bar = 2.0 if smoke else 20.0

    # ---- section A: network grid, chunked vs monolithic vs scalar --------
    mono_s, res = _best_of(lambda: sweep(traffic, topologies=TOPOLOGIES,
                                         device=device, **axes))
    chunk_s, counted = _best_of(lambda: sweep_chunked(
        traffic, _NullReducer(), topologies=TOPOLOGIES,
        chunk_size=net_chunk, device=device, **axes))
    assert counted == n_net
    grid = build_grid(TOPOLOGIES, **axes)
    scalar_cps = _scalar_sample_cps(traffic, grid)
    mono_front = pareto_front(res, device=device)
    t0 = time.perf_counter()
    stream_front = pareto_search(traffic, topologies=TOPOLOGIES,
                                 chunk_size=search_chunk, device=device,
                                 **axes)
    net_search_s = time.perf_counter() - t0
    net_pts = np.stack([res.metrics[k] for k in OBJECTIVES], -1)
    net_fronts_equal = (
        np.array_equal(mono_front.points, stream_front.points)
        and np.array_equal(mono_front.indices, stream_front.indices))
    net_front_exact = verify_front_exact(stream_front, net_pts, device)
    if smoke:
        net_front_exact = net_front_exact and np.array_equal(
            np.sort(stream_front.indices),
            np.where(pareto_mask_reference(net_pts))[0])

    network = {
        "n_configs": n_net,
        "chunk_size": net_chunk,
        "monolithic_s": mono_s,
        "chunked_s": chunk_s,
        "monolithic_configs_per_s": n_net / mono_s,
        "chunked_configs_per_s": n_net / chunk_s,
        "chunked_over_monolithic": chunk_s / mono_s,
        "scalar_configs_per_s": scalar_cps,
        "batched_over_scalar": (n_net / mono_s) / scalar_cps,
        "front_size": stream_front.size,
        "front_indices": stream_front.indices.tolist(),
        "pareto_search_s": net_search_s,
        "best_config": stream_front.configs(spec)[0],
    }

    # ---- section A2: streaming pipeline, host-serial vs device-pipelined -
    pipe_axes = dict(axes) if smoke else dict(axes, **PIPE_EXTRA_AXIS)
    n_pipe = grid_spec(TOPOLOGIES, **pipe_axes).n
    pipe_chunk = max(1, n_pipe // 3) if smoke else 65536

    def _stream(mat: str, depth: int):
        return sweep_chunked(
            traffic, MinReducer("energy_j"), topologies=TOPOLOGIES,
            chunk_size=pipe_chunk, materialize=mat, prefetch=depth,
            device=device, **pipe_axes)

    _stream("device", 2)  # warm the allocator at the pipeline shape
    reps = 3 if smoke else 2
    host_s, host_best = _best_of(lambda: _stream("host", 0), repeats=reps)
    dev_s, dev_best = _best_of(lambda: _stream("device", 0), repeats=reps)
    pipe_s, pipe_best = _best_of(lambda: _stream("device", 2), repeats=reps)
    pipe_identical = (
        host_best["index"] == dev_best["index"] == pipe_best["index"]
        and host_best["value"] == dev_best["value"] == pipe_best["value"])
    pipe_speedup = host_s / pipe_s
    pipeline = {
        "n_configs": n_pipe,
        "chunk_size": pipe_chunk,
        "prefetch_depth": 2,
        "host_serial_s": host_s,
        "device_serial_s": dev_s,
        "pipelined_s": pipe_s,
        "host_serial_configs_per_s": n_pipe / host_s,
        "device_serial_configs_per_s": n_pipe / dev_s,
        "pipelined_configs_per_s": n_pipe / pipe_s,
        "pipelined_over_host_serial": pipe_speedup,
        "overlap_gain_over_device_serial": dev_s / pipe_s,
        "speedup_bar": PIPELINE_SPEEDUP_BAR,
        "best_index": int(host_best["index"]),
        "best_energy_j": float(host_best["value"]),
    }

    # ---- section B: co-design grid (network x chiplet mix) ---------------
    # both reference paths build nets with the SAME device selection the
    # streaming co-design engine runs (network_columns_device): numpy's and
    # torch's transcendentals may differ in the last ulp, so the exact-front
    # equality checks below need the engine's nets, not the numpy path's.
    # A chunk's columns, nets and result stay on the device (one copy of
    # the decoded columns there, none back): both timed paths end in one
    # synchronize, and only the monolithic result is read back, untimed.
    # The chunked path runs each chunk as one program (`CodesignChunk`: one
    # CUDA graph replayed per chunk on the card, as the reference's chunk is
    # one jitted program); the monolithic path runs the functions eagerly
    dev = require_device(device)
    program = CodesignChunk(wl, mixes, spec.topologies, cd_chunk, device=dev)

    def _eval_cols(cols, topo_id):
        cols = {k: torch.as_tensor(v, device=dev) for k, v in cols.items()}
        nets = network_columns_device(cols, topo_id, spec.topologies,
                                      device=dev, as_numpy=False)
        return evaluate_accelerator_grid(
            wl, mixes, nets, cols,
            cols["n_mem_chiplets"] * cols["mem_bw_bytes_per_s"],
            device=dev, as_numpy=False)

    def _grid_eval(start, stop):
        return _eval_cols(*spec.chunk_cols(start, stop))

    def _synced(fn):
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    def _chunk_eval(start, stop):
        return program(*spec.chunk_cols(start, stop))

    def eval_chunked():
        rows = 0
        for start in range(0, n_net, cd_chunk):
            stop = min(start + cd_chunk, n_net)
            _chunk_eval(start, stop)
            rows += stop - start
        return rows

    _synced(lambda: _chunk_eval(0, min(cd_chunk, n_net)))  # capture the program
    cd_chunk_s, _ = _best_of(lambda: _synced(eval_chunked), repeats=3 if smoke else 2)
    # every chunk of the program equals the eager evaluation of the rows
    # it ran (the last chunk padded), bit for bit (untimed)
    cd_program_exact = True
    for start in range(0, n_net, cd_chunk):
        stop = min(start + cd_chunk, n_net)
        got = _chunk_eval(start, stop)
        cols, topo_id = program.inputs
        want = _eval_cols(cols, topo_id.cpu())
        cd_program_exact &= all(torch.equal(got[k], want[k][..., :stop - start])
                                for k in want)

    t0 = time.perf_counter()
    cd_front, _ = codesign_pareto(wl, mixes, topologies=TOPOLOGIES,
                                  chunk_size=cd_search_chunk, device=device,
                                  **axes)
    cd_search_s = time.perf_counter() - t0

    # bounded-memory evidence: the process high-water mark is sampled after
    # ALL chunked co-design work but before the monolithic full-grid
    # evaluation below ever runs
    peak_rss_after_chunked_mb = (
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024)

    cd_mono_s, cd_out = _best_of(lambda: _synced(lambda: _grid_eval(0, n_net)),
                                 repeats=3 if smoke else 2)
    cd_out = {k: v.cpu().numpy() for k, v in cd_out.items()}

    cd_pts = np.stack([cd_out[k] for k in OBJECTIVES], -1).reshape(-1, 3)
    t0 = time.perf_counter()
    cd_mono_front = _front_of(cd_pts, np.arange(cd_pts.shape[0]), OBJECTIVES,
                              device=device)
    cd_mono_front_s = time.perf_counter() - t0
    cd_fronts_equal = (
        np.array_equal(cd_front.points, cd_mono_front.points)
        and np.array_equal(cd_front.indices, cd_mono_front.indices))
    t0 = time.perf_counter()
    cd_front_exact = verify_front_exact(cd_front, cd_pts, device)
    cd_verify_s = time.perf_counter() - t0
    if smoke:
        cd_front_exact = cd_front_exact and np.array_equal(
            np.sort(cd_front.indices),
            np.where(pareto_mask_reference(cd_pts))[0])

    # bounded memory: streaming holds one chunk of joint lanes + the front
    n_layers = len(wl.layers)
    chunk_bytes = len(mixes) * cd_chunk * n_layers * 8
    mono_bytes = len(mixes) * n_net * n_layers * 8
    # ---- gradient refinement from the best EDP front point ---------------
    best_joint = _edp_argmin(cd_front)
    mix_id, row = divmod(best_joint, n_net)
    t0 = time.perf_counter()
    refine = refine_front_point(spec, traffic, row, steps=8 if smoke else 48,
                                lr=0.1, device=device)
    refine_s = time.perf_counter() - t0

    # ---- refined front: joint accelerator+network refinement -------------
    # the top-k best-EDP frontier seeds refined jointly over accelerator
    # axes (per-chiplet n_units/vector_size, mac_rate_hz,
    # lambda_slot_energy_j) and network axes, rounded and exactly re-scored,
    # merged back into the seed front
    t0 = time.perf_counter()
    rf = refine_front(cd_front, spec, mixes, wl, top_k=3,
                      steps=6 if smoke else 32, lr=0.1, device=device)
    refined_front_s = time.perf_counter() - t0
    merged_front = rf["front"]
    refined_dominates = _weakly_dominates(merged_front, cd_front)

    # ---- trust-region multi-workload refined front -----------------------
    # the same seeds with the second-order engine against a three-CNN batch
    # (weighted-geomean EDP), n_gateways among the refined axes so the
    # integer line search walks a network axis too; the front's points stay
    # the FIRST workload's (ResNet18) exact metrics, comparable with the
    # first-order front
    tr_workloads = [wl] + [CNN_WORKLOADS[n]() for n in TR_WORKLOADS]
    t0 = time.perf_counter()
    rf_tr = refine_front(cd_front, spec, mixes, tr_workloads, top_k=3,
                         method="trust_region", refine_axes=TR_AXES,
                         steps=6 if smoke else 32, device=device)
    tr_front_s = time.perf_counter() - t0
    # unioned with the first-order front, weak dominance over it holds by
    # construction; the brute force re-verifies that the merge lost nothing
    tr_front = merge_fronts(rf_tr["front"], merged_front, device=device)
    tr_dominates_fo = _weakly_dominates(tr_front, merged_front)
    tr_rescore_exact = all(_rescore_exact(r, spec, tr_workloads, device)
                           for r in rf_tr["results"])

    codesign = {
        "n_networks": n_net,
        "n_mixes": len(mixes),
        "n_joint_points": n_joint,
        "n_layers": n_layers,
        "chunk_size": cd_chunk,
        "search_chunk_size": cd_search_chunk,
        "chunked_s": cd_chunk_s,
        "monolithic_s": cd_mono_s,
        "chunked_points_per_s": n_joint / cd_chunk_s,
        "monolithic_points_per_s": n_joint / cd_mono_s,
        "chunked_over_monolithic": cd_chunk_s / cd_mono_s,
        "chunk_program": "cuda_graph" if dev.type == "cuda" else "eager",
        "pareto_search_s": cd_search_s,
        "pareto_search_points_per_s": n_joint / cd_search_s,
        "monolithic_front_s": cd_mono_front_s,
        "verify_s": cd_verify_s,
        "front_size": cd_front.size,
        "front_indices": cd_front.indices.tolist(),
        "chunk_working_set_bytes": chunk_bytes,
        "monolithic_working_set_bytes": mono_bytes,
        "peak_rss_after_chunked_mb": peak_rss_after_chunked_mb,
        "best_edp_index": best_joint,
        "best_edp_config": dict(spec.config_at(row), mix=mix_id,
                                chiplets=[str(c) for c in mixes[mix_id]]),
        "refined_edp_improvement": refine["improvement"],
        "refine_s": refine_s,
    }

    best_gain = max(r["improvement"] for r in rf["results"])
    refined_front = {
        "seeds_refined": len(rf["results"]),
        "seed_front_size": cd_front.size,
        "merged_front_size": merged_front.size,
        "n_improved": rf["n_improved"],
        "best_improvement": best_gain,
        "refine_front_s": refined_front_s,
        "sensitivity": rf["sensitivity"],
        "improvements": [r["improvement"] for r in rf["results"]],
        "n_candidates": [r["n_candidates"] for r in rf["results"]],
    }

    tr_best_gain = max(r["improvement"] for r in rf_tr["results"])
    trust_region_front = {
        "seeds_refined": len(rf_tr["results"]),
        "workloads": rf_tr["results"][0]["workloads"],
        "first_order_front_size": merged_front.size,
        "trust_region_front_size": tr_front.size,
        "n_improved": rf_tr["n_improved"],
        "best_improvement": tr_best_gain,
        "refine_front_s": tr_front_s,
        "improvements": [r["improvement"] for r in rf_tr["results"]],
        "tr_accepted": [r["tr_stats"]["accepted"] for r in rf_tr["results"]],
        "tr_rejected": [r["tr_stats"]["rejected"] for r in rf_tr["results"]],
        "line_search": [r["line_search"] for r in rf_tr["results"]],
        "sensitivity": rf_tr["sensitivity"],
    }

    checks = {
        "codesign_grid_at_least_1e6": n_joint >= 1_000_000,
        "net_front_streaming_equals_monolithic": bool(net_fronts_equal),
        "net_front_matches_bruteforce": bool(net_front_exact),
        "codesign_front_streaming_equals_monolithic": bool(cd_fronts_equal),
        "codesign_front_matches_bruteforce": bool(cd_front_exact),
        "codesign_chunk_program_bit_identical": bool(cd_program_exact),
        "chunked_within_ratio_bar_network":
            network["chunked_over_monolithic"] <= ratio_bar,
        "chunked_within_ratio_bar_codesign":
            codesign["chunked_over_monolithic"] <= ratio_bar,
        "batched_over_scalar_bar": network["batched_over_scalar"]
            >= speedup_bar,
        "pipeline_modes_bit_identical": bool(pipe_identical),
        "pipeline_grid_at_least_1e6": n_pipe >= 1_000_000,
        "pipelined_speedup_at_least_1p2":
            pipe_speedup >= PIPELINE_SPEEDUP_BAR,
        "refinement_improves": refine["improvement"] >= -1e-12,
        "refined_front_dominates_seed": refined_dominates,
        "refined_improves_a_seed": rf["n_improved"] >= 1,
        "trust_region_front_dominates_first_order": tr_dominates_fo,
        "trust_region_rescore_bit_identical": tr_rescore_exact,
    }
    # mode-dependent expectations (the grid sizes, the pipeline's timing
    # bar that a tiny CI grid cannot amortize, and whether a handful of
    # smoke-length descent steps must strictly beat an exactly-scored seed)
    # are exempted in smoke but still computed and flagged — never silently
    # rewritten; the dominance and bit-identity gates hold in both modes
    smoke_exempt = ("codesign_grid_at_least_1e6", "refined_improves_a_seed",
                    "pipeline_grid_at_least_1e6",
                    "pipelined_speedup_at_least_1p2")
    required = [k for k in checks if smoke is False or k not in smoke_exempt]
    out = {
        "smoke": smoke,
        "device": str(device),
        "ratio_bar": ratio_bar,
        "speedup_bar": speedup_bar,
        "network": network,
        "pipeline": pipeline,
        "codesign": codesign,
        "refine": {k: refine[k] for k in
                   ("start_value", "refined_value", "improvement",
                    "refine_axes", "refined")},
        "refined_front": refined_front,
        "trust_region_front": trust_region_front,
        "checks": checks,
        "required_checks": required,
        "pass": all(checks[k] for k in required),
    }

    ARTIFACTS.mkdir(exist_ok=True)
    (ARTIFACTS / "torch_pareto_bench.json").write_text(
        json.dumps(out, indent=2, default=float))

    if csv:
        print(f"torch_pareto/net,{mono_s * 1e6 / n_net:.2f},"
              f"monolithic {n_net / mono_s:,.0f} cfg/s over {n_net}")
        print(f"torch_pareto/net_chunked,{chunk_s * 1e6 / n_net:.2f},"
              f"chunked {n_net / chunk_s:,.0f} cfg/s "
              f"({network['chunked_over_monolithic']:.2f}x mono, "
              f"bar {ratio_bar}x)")
        print(f"torch_pareto/net_scalar,{1e6 / scalar_cps:.2f},"
              f"{scalar_cps:,.0f} cfg/s; batched "
              f"{network['batched_over_scalar']:.0f}x (bar {speedup_bar}x)")
        print(f"torch_pareto/pipeline,{pipe_s * 1e6 / n_pipe:.2f},"
              f"{n_pipe} rows: host-serial {n_pipe / host_s:,.0f} cfg/s, "
              f"device-serial {n_pipe / dev_s:,.0f} cfg/s, pipelined "
              f"{n_pipe / pipe_s:,.0f} cfg/s "
              f"({pipe_speedup:.2f}x host-serial, bar "
              f"{PIPELINE_SPEEDUP_BAR}x)")
        print(f"torch_pareto/codesign,{cd_mono_s * 1e6 / n_joint:.3f},"
              f"{n_joint} joint pts, chunked "
              f"{codesign['chunked_over_monolithic']:.2f}x mono, "
              f"front {cd_front.size}, peak rss after chunked "
              f"{codesign['peak_rss_after_chunked_mb']} MB")
        print(f"torch_pareto/refine,0,EDP {refine['start_value']:.3e} -> "
              f"{refine['refined_value']:.3e} "
              f"({100 * refine['improvement']:.1f}% better)")
        print(f"torch_pareto/refined_front,{refined_front_s * 1e6:.0f},"
              f"{refined_front['seeds_refined']} seeds refined, "
              f"{refined_front['n_improved']} improved "
              f"(best {100 * best_gain:.1f}%), front "
              f"{cd_front.size} -> {merged_front.size}")
        print(f"torch_pareto/trust_region_front,{tr_front_s * 1e6:.0f},"
              f"{trust_region_front['seeds_refined']} seeds x "
              f"{len(trust_region_front['workloads'])} workloads, "
              f"{trust_region_front['n_improved']} improved "
              f"(best {100 * tr_best_gain:.1f}%), front "
              f"{merged_front.size} -> {tr_front.size}")
        for k, v in checks.items():
            flag = "PASS" if v else (
                "FAIL" if k in required else "SKIP(smoke)")
            print(f"torch_pareto/check/{k},0,{flag}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
