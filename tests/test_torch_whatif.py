"""Parity of the port's communication layer's one-device parts and of the
benchmarks that price LM steps over photonic fabrics with the JAX package
on the CPU: the compressed all-reduce's int8 chunk quantizer
(`repro_torch.parallel.collectives._quantize_int8`/`_dequantize_int8`), the
collectives' byte model (`collective_bytes_estimate`), `configs.SHAPES` and
`supports_shape`, `launch.dryrun.model_flops_per_device`, and
`benchmarks/torch_collectives_bench.py`, `torch_fabric_whatif.py` and
`torch_roofline.py` in smoke mode against the reference's scripts; and the
counterparts of the reference's own tests of these (`tests/test_fabric.py`'s
per-chunk quantizer tests, `tests/test_benchmarks_smoke.py`'s what-if,
roofline and collectives tests).

Tolerances: int8 levels, scales and dequantized values exactly (the same
f32 arithmetic); the byte model, shapes and model FLOPs exactly (the same
host arithmetic); the benchmarks' outputs at rtol 1e-12 with every
discrete field (names, bottlenecks, rankings, checks) equal.
"""

import ast
import dataclasses
import os
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

# `repro.parallel.collectives` and the reference's benches import
# `repro.core`, whose power model imports `jax.experimental.enable_x64`;
# newer jax only has `jax.enable_x64`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core.planner import plan_collective_channels as j_plan  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.parallel import collectives as JCOL  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch.launch.dryrun import model_flops_per_device  # noqa: E402
from repro_torch.parallel import collectives as COL  # noqa: E402

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _low_cpu_priority():
    """This module runs both packages' what-if searches; it runs at a lower
    scheduling priority so that timing-gated tests that share the machine
    (the benchmark smoke tests' ratio bars) keep theirs, as
    `tests/test_torch_train.py` does."""
    os.nice(10)
    yield
    try:
        os.nice(-10)
    except PermissionError:
        pass


def _ref_model_flops_per_device():
    """The reference's `launch.dryrun.model_flops_per_device`, compiled from
    its source alone: importing that module sets XLA_FLAGS to 512 host
    devices for the whole process."""
    src = Path(JC.__file__).resolve().parents[1] / "launch" / "dryrun.py"
    fn = next(n for n in ast.parse(src.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "model_flops_per_device")
    ns = {"ModelConfig": JModelConfig}
    exec(compile(ast.Module([fn], []), str(src), "exec"), ns)
    return ns["model_flops_per_device"]


def _same(got, want, path="", rtol=RTOL) -> None:
    """`got` equal to `want`: floats at `rtol`, everything else exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _same(got[k], want[k], f"{path}/{k}", rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]", rtol)
    elif isinstance(want, float) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=path)
    else:
        assert got == want, (path, got, want)


# ---------------------------------------------------------------------------
# the int8 chunk quantizer
# ---------------------------------------------------------------------------


def _vector(n, seed=0, spike=None):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if spike is not None:
        x[spike] = 100.0
    return x


@pytest.mark.parametrize("chunk", [None, 1, 256, 1000, 4096, 10_000])
@pytest.mark.parametrize("n,spike", [(4096, None), (4096, 17), (7, None), (1000, 3)])
def test_quantize_int8_matches_reference(n, spike, chunk):
    """Levels (padding included), per-chunk scales and the dequantized
    values exactly."""
    x = _vector(n, spike=spike)
    jq, js = JCOL._quantize_int8(jnp.asarray(x), chunk)
    q, s = COL._quantize_int8(torch.from_numpy(x), chunk)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(COL._dequantize_int8(q, s, n).numpy(),
                                  np.asarray(JCOL._dequantize_int8(jq, js, n)))


def test_pad_to_matches_reference():
    x = np.arange(14, dtype=np.float32).reshape(7, 2)
    for mult in (1, 3, 7, 8):
        jp, jn = JCOL._pad_to(jnp.asarray(x), mult)
        p, n = COL._pad_to(torch.from_numpy(x), mult)
        assert n == jn == 7
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


def _rel_err(x, chunk_elems):
    q, s = COL._quantize_int8(x, chunk_elems)
    deq = COL._dequantize_int8(q, s, x.shape[0])
    return float(torch.linalg.norm(deq - x) / torch.linalg.norm(x))


def test_per_chunk_quantize_matches_global_on_smooth_tensors():
    x = torch.sin(torch.linspace(0.0, 20.0, 4096)) * 3.0
    err_global = _rel_err(x, None)
    err_chunked = _rel_err(x, 256)
    assert err_global < 0.01
    assert err_chunked <= err_global * 1.5 + 1e-6


def test_per_chunk_quantize_wins_on_outlier_heavy_tensors():
    """One huge spike must not flatten every other chunk's resolution."""
    x = torch.from_numpy(_vector(4096) * 1e-3)
    x[17] = 100.0

    def small_part_err(chunk_elems):
        q, s = COL._quantize_int8(x, chunk_elems)
        deq = COL._dequantize_int8(q, s, x.shape[0])
        d, r = deq[256:], x[256:]          # everything outside the spike's chunk
        return float(torch.linalg.norm(d - r) / torch.linalg.norm(r))

    assert small_part_err(None) > 0.99     # one global scale rounds them to zero
    assert small_part_err(256) < 0.01
    _, scales = COL._quantize_int8(x, 256)
    assert tuple(scales.shape) == (16,)
    assert float(scales.max()) > 10 * float(scales.min())


def test_quantize_chunk_handles_padding_and_clamp():
    x = torch.arange(7.0) - 3.0            # length not divisible by the chunk
    q, s = COL._quantize_int8(x, 4)
    assert tuple(q.shape) == (2, 4) and tuple(s.shape) == (2,)
    deq = COL._dequantize_int8(q, s, 7)
    assert tuple(deq.shape) == (7,)
    np.testing.assert_allclose(deq.numpy(), x.numpy(), atol=0.05)
    q1, s1 = COL._quantize_int8(x, 10_000)  # larger than the tensor: one scale
    assert tuple(s1.shape) == (1,)


# ---------------------------------------------------------------------------
# the byte model, the planner re-export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 1000, 1 << 20])
@pytest.mark.parametrize("schedule", ["flat", "trine", "trine_int8"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2), (2, 16, 16)])
def test_collective_bytes_estimate_matches_reference(shape, schedule, chunk):
    mesh = COL.MeshGeometry(shape)
    for n, dtype_bytes in ((1, 4), (1_000_003, 2), (int(6.1e9 / 256), 2), (2 ** 31, 4)):
        want = JCOL.collective_bytes_estimate(n, dtype_bytes, mesh, schedule, chunk)
        got = COL.collective_bytes_estimate(n, dtype_bytes, mesh, schedule, chunk)
        assert got == want, (shape, schedule, chunk, n)


def test_collective_bytes_estimate_on_a_two_axis_mesh_and_unknown_schedule():
    mesh = COL.MeshGeometry((16, 16), ("data", "model"))
    for s in ("flat", "trine", "trine_int8"):
        assert (COL.collective_bytes_estimate(12345, 2, mesh, s)
                == JCOL.collective_bytes_estimate(12345, 2, mesh, s))
    with pytest.raises(ValueError):
        COL.collective_bytes_estimate(1, 2, mesh, "ring")


def test_plan_channels_is_the_planners():
    for b, w, bw in ((3.87e9, 50e-3, 100e9), (1e6, 1e-3, 12e9), (0.0, 1.0, 1.0)):
        assert (COL.plan_channels(b, w, bw, max_channels=64)
                == j_plan(b, w, bw, max_channels=64))
    assert COL.plan_channels(3.87e9, 50e-3, fabric="trine_siph") == j_plan(
        3.87e9, 50e-3, fabric="trine_siph")


# ---------------------------------------------------------------------------
# shapes and model FLOPs
# ---------------------------------------------------------------------------


def test_shapes_match_reference():
    assert list(C.SHAPES) == list(JC.SHAPES)
    for name, s in JC.SHAPES.items():
        assert dataclasses.asdict(C.SHAPES[name]) == dataclasses.asdict(s)


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_supports_shape_and_model_flops_match_reference(arch):
    cfg, jcfg = C.get(arch), JC.get(arch)
    ref_flops = _ref_model_flops_per_device()
    for name in JC.SHAPES:
        assert C.supports_shape(cfg, C.SHAPES[name]) == JC.supports_shape(jcfg, JC.SHAPES[name])
        for n_dev in (1, 256, 512):
            assert (model_flops_per_device(cfg, C.SHAPES[name], n_dev)
                    == ref_flops(jcfg, JC.SHAPES[name], n_dev)), (name, n_dev)


# ---------------------------------------------------------------------------
# the three benchmarks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def whatif_pair():
    """One smoke what-if run of each package (each spans a Pareto search)."""
    import benchmarks.fabric_whatif as ref
    import benchmarks.torch_fabric_whatif as port
    return port.run(csv=False, smoke=True, device="cpu"), ref.run(csv=False, smoke=True)


def test_torch_fabric_whatif_matches_reference(whatif_pair):
    """Every section equal: fabrics, cells, results, ranking, frontier
    ranking, front size, checks (the timing `elapsed_s` aside)."""
    got, want = ({k: v for k, v in out.items() if k != "elapsed_s"} for out in whatif_pair)
    _same(got, want)


def test_torch_fabric_whatif_smoke(whatif_pair):
    """The reference test's bars (`test_fabric_whatif_benchmark_smoke`) on
    the port: >= 3 fabrics (metallic baseline, photonic presets, co-design
    frontier points), every cell priced under every fabric, and the ranked
    frontier the fabrics that came from the EDP front."""
    import benchmarks.torch_fabric_whatif as b
    out = whatif_pair[0]
    assert out["pass"], out["checks"]
    assert len(out["fabrics"]) >= 3
    assert any(f["kind"] == "frontier" for f in out["fabrics"])
    assert len(out["results"]) == len(out["cells"]) * len(out["fabrics"])
    frontier_names = {f["name"] for f in out["fabrics"] if f["kind"] == "frontier"}
    assert set(out["frontier_ranking"]) == frontier_names
    assert (b.ARTIFACTS / "torch_fabric_whatif.json").exists()
    assert b.markdown_table(out).count("|") > 20


def test_torch_roofline_matches_reference():
    """The photonic roofline at rtol 1e-12 with the same bottlenecks; the
    dry-run sections read each package's own dry-run artifacts (the port's
    `artifacts/torch_dryrun/`): `n_ok` counts the port's ok records."""
    import benchmarks.roofline as ref
    import benchmarks.torch_roofline as port
    got, want = port.run(csv=False, device="cpu"), ref.run(csv=False)
    _same({k: v for k, v in got.items() if k != "fabric" and not k.startswith("n_")},
          {k: v for k, v in want.items() if k != "fabric" and not k.startswith("n_")})
    assert got["n_ok"] == sum(r["status"] == "ok" for r in port.load_cells())
    assert port.OUT.exists()
    assert port.photonic_markdown_table(got["photonic"]) == ref.photonic_markdown_table(
        want["photonic"])


def test_torch_roofline_fabric_columns():
    """The reference test's bars (`test_roofline_fabric_columns`) on the
    port, and its rows equal to the reference's for the same cell."""
    import benchmarks.roofline as ref
    import benchmarks.torch_roofline as b
    cell = {"arch": "yi_6b", "shape": "decode_32k", "mesh": "single",
            "status": "ok", "collective_op_counts": {"all-reduce": 65},
            "roofline": {"flops": 3.0e9, "hbm_bytes": 5.6e8,
                         "collective_bytes": 9.8e6, "model_flops": 3.0e9}}
    rows = b.fabric_cells([cell])
    _same(rows, ref.fabric_cells([cell]))
    assert [r["fabric"] for r in rows] == list(b.FABRIC_NAMES)
    by = {r["fabric"]: r for r in rows}
    assert by["trine_siph"]["collective_s"] < by["metallic_ici"]["collective_s"]
    assert by["tree_siph"]["collective_s"] > by["metallic_ici"]["collective_s"]
    assert by["metallic_ici"]["bottleneck"] == "memory"
    assert by["tree_siph"]["bottleneck"] == "collective"
    assert b.fabric_markdown_table(rows) == ref.fabric_markdown_table(rows)


def test_torch_collectives_bench_matches_reference():
    import benchmarks.collectives_bench as ref
    import benchmarks.torch_collectives_bench as port
    got = port.run(csv=False)
    assert got and len(got["rows"]) == len(port.GRAD_SIZES)
    _same(got, ref.run(csv=False))
    assert (port.ARTIFACTS / "torch_collectives.json").exists()


def test_benches_refuse_a_missing_card(monkeypatch):
    """The benches that run on a device (the what-if's co-design search, the
    roofline's photonic section): `device` defaults to "cuda" and raises
    without a card; nothing falls back to the CPU."""
    import benchmarks.torch_fabric_whatif as wb
    import benchmarks.torch_roofline as rb
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda **kw: wb.run(smoke=True, **kw), rb.run):
        with pytest.raises(RuntimeError, match="cuda"):
            run(csv=False)
