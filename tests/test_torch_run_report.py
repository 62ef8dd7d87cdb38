"""The port's benchmark harness and report (`benchmarks/torch_run.py`,
`benchmarks/torch_report.py`) against the reference's (`benchmarks/run.py`,
`benchmarks/report.py`) on the CPU.

The harness: the port's sweep, Pareto and fabric what-if benchmarks in
smoke mode consolidate into a passing summary, as
`tests/test_benchmarks_smoke.py::test_run_summary_consolidation` holds the
reference's, and the summary's check names, perf gates (with their bars),
refinement block and the trajectory record carry the reference's keys
over the reference's smoke results.  Both packages' benchmarks write their
artifacts into the test's temporary directory here, so that the tests that
read the repository's artifacts back are not raced.

The report: three reduced dry-run processes of the port (`python -m
repro_torch.launch.dryrun --reduced --out`: yi-6b train_4k on both meshes,
deepseek-67b train_4k with and without the `fsdp_all` tag, and yi-6b
long_500k, which is skipped) write records that both reports render, the
reference's with its `ARTIFACTS` pointed at them: the same table rows.
Then the reference's create, idempotence and prose test on the port's
report; `EXPERIMENTS.md` keeps its bytes throughout.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental
import pytest

# the reference's benchmarks import `repro.core.power`, which imports
# `jax.experimental.enable_x64`; newer jax only has `jax.enable_x64`
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

REPO = Path(__file__).resolve().parents[1]
EXPERIMENTS = REPO / "EXPERIMENTS.md"
DRYRUNS = (("yi-6b", "train_4k", "both", ()),
           ("deepseek-67b", "train_4k", "single", ()),
           ("deepseek-67b", "train_4k", "single", ("--strategy", "fsdp_all", "--tag", "fsdp_all")),
           ("yi-6b", "long_500k", "single", ()))
SMOKE_EXEMPT = ("pareto/codesign_grid_at_least_1e6", "pareto/refined_improves_a_seed",
                "pareto/pipeline_grid_at_least_1e6", "pareto/pipelined_speedup_at_least_1p2",
                "sweep/grid_at_least_4096")
# the port's Pareto bench holds its graphed co-design chunks against the
# eager evaluation: a check the reference, which compiles one program, lacks
PORT_ONLY_CHECKS = {"pareto/codesign_chunk_program_bit_identical"}


@pytest.fixture(scope="module", autouse=True)
def experiments_bytes():
    """`EXPERIMENTS.md` before this module's tests, held against its bytes
    after them."""
    before = EXPERIMENTS.read_bytes()
    yield
    assert EXPERIMENTS.read_bytes() == before


@pytest.fixture(scope="module")
def smoke_results(tmp_path_factory):
    """The smoke results of the three benchmarks in both packages, their
    artifacts written under a temporary directory.  The port's run first
    (its summary gates its timing ratios); then the rest of this module
    at a lower scheduling priority, as `tests/test_torch_whatif.py` runs,
    so that the timing-gated tests that share the machine keep theirs."""
    import benchmarks.fabric_whatif as rf
    import benchmarks.pareto_bench as rp
    import benchmarks.sweep_bench as rs
    import benchmarks.torch_fabric_whatif as pf
    import benchmarks.torch_pareto_bench as pp
    import benchmarks.torch_sweep_bench as ps
    tmp = tmp_path_factory.mktemp("bench_artifacts")
    with pytest.MonkeyPatch.context() as mp:
        for mod in (rf, rp, rs, pf, pp, ps):
            mp.setattr(mod, "ARTIFACTS", tmp)
        port = {"sweep": ps.run(csv=False, smoke=True, device="cpu"),
                "pareto": pp.run(csv=False, smoke=True, device="cpu"),
                "fabric_whatif": pf.run(csv=False, smoke=True, device="cpu")}
        os.nice(10)
        ref = {"sweep": rs.run(csv=False, smoke=True),
               "pareto": rp.run(csv=False, smoke=True),
               "fabric_whatif": rf.run(csv=False, smoke=True)}
    return port, ref


def _keys(tree, prefix=""):
    """Every key path of a nested dict."""
    if not isinstance(tree, dict):
        return set()
    out = set()
    for k, v in tree.items():
        out |= {f"{prefix}{k}"} | _keys(v, f"{prefix}{k}/")
    return out


def test_port_summary_consolidates_and_passes(smoke_results):
    """`test_run_summary_consolidation`'s assertions on the port's results."""
    import benchmarks.torch_run as runner
    summary = runner.build_summary(smoke_results[0])
    assert summary["pass"], (summary["checks"], summary["perf"])
    assert summary["checks"]["pareto/trust_region_front_dominates_first_order"]
    assert summary["checks"]["pareto/trust_region_rescore_bit_identical"]
    ref = summary["refinement"]
    assert ref["trust_region_dominates_first_order"] is True
    assert ref["trust_region"]["best_improvement"] is not None
    assert ref["first_order"]["merged_front_size"] >= 1
    for gate in ("batched_over_scalar", "chunked_over_monolithic_network",
                 "chunked_over_monolithic_codesign"):
        assert summary["perf"][gate]["pass"], summary["perf"][gate]
    for check in ("schema_keys", "schema_result_rows", "schema_has_frontier",
                  "bottleneck_flip_frontier_fabric"):
        assert summary["checks"][f"fabric_whatif/{check}"], check
    for check in SMOKE_EXEMPT:
        assert check not in summary["checks"], check


@pytest.mark.parametrize("part", ["checks", "perf", "refinement"])
def test_summary_keys_equal_reference(smoke_results, part):
    """The port's summary has the reference's check names (and its one
    own check), perf gates (each at the reference's bar) and refinement
    block, key for key."""
    import benchmarks.run as ref_runner
    import benchmarks.torch_run as runner
    got = runner.build_summary(smoke_results[0])[part]
    want = ref_runner.build_summary(smoke_results[1])[part]
    assert _keys(got) == _keys(want) | (PORT_ONLY_CHECKS if part == "checks" else set())
    if part == "perf":
        assert {k: g["bar"] for k, g in got.items()} == {k: g["bar"] for k, g in want.items()}


def test_bench9_and_schema_equal_reference(smoke_results):
    """The trajectory record's keys, and the what-if schema gate on the
    same input, as the reference's; the smoke flag and grid sizes equal."""
    import benchmarks.run as ref_runner
    import benchmarks.torch_run as runner
    port, ref = smoke_results
    got, want = runner.build_bench9(port), ref_runner.build_bench9(ref)
    assert _keys(got) == _keys(want)
    assert got["smoke"] is want["smoke"] is True
    assert got["grid_sizes"] == want["grid_sizes"]
    for res in (port["fabric_whatif"], ref["fabric_whatif"]):
        assert runner.check_fabric_whatif_schema(res) == \
            ref_runner.check_fabric_whatif_schema(res)


def test_write_summary_targets_the_port_files(smoke_results, tmp_path, monkeypatch):
    """`write_summary` and `write_bench9` write `torch_summary.json` and
    `torch_bench9.json`, never the reference's names."""
    import json
    import benchmarks.torch_run as runner
    assert runner.ARTIFACTS == REPO / "benchmarks" / "artifacts"
    monkeypatch.setattr(runner, "ARTIFACTS", tmp_path)
    summary = runner.write_summary(smoke_results[0])
    bench9 = runner.write_bench9(smoke_results[0])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["torch_bench9.json",
                                                          "torch_summary.json"]
    assert json.loads((tmp_path / "torch_summary.json").read_text())["pass"] == summary["pass"]
    assert json.loads((tmp_path / "torch_bench9.json").read_text()) == bench9


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The reduced dry-run records, the processes started together."""
    out = tmp_path_factory.mktemp("torch_dryrun")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                               "--shape", s, "--mesh", m, "--reduced", *extra,
                               "--out", str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a, s, m, extra in DRYRUNS]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    names = sorted(p.name for p in out.iterdir())
    assert names == ["deepseek_67b__train_4k__single.json",
                     "deepseek_67b__train_4k__single__fsdp_all.json",
                     "yi_6b__long_500k__single.json", "yi_6b__train_4k__multi.json",
                     "yi_6b__train_4k__single.json"], names
    return out


@pytest.fixture
def ref_report(records, monkeypatch):
    import benchmarks.report as report
    import benchmarks.roofline as roofline
    monkeypatch.setattr(roofline, "ARTIFACTS", records)
    monkeypatch.setattr(report, "ARTIFACTS", records)
    return report


@pytest.mark.parametrize("mesh,tagged", [("single", False), ("multi", False),
                                         ("single", True)])
def test_table_rows_equal_reference(records, ref_report, mesh, tagged):
    import benchmarks.torch_report as port
    got = port.table(mesh, include_tagged=tagged, artifacts=records)
    assert got == ref_report.table(mesh, include_tagged=tagged)
    assert got.count("\n") >= (3 if mesh == "single" else 2)


def test_perf_table_rows_equal_reference(records, ref_report):
    import benchmarks.torch_report as port
    got = port.perf_table(artifacts=records)
    assert got == ref_report.perf_table()
    assert "| deepseek_67b/train_4k | fsdp_all |" in got
    assert "| deepseek_67b/train_4k | baseline (tp_fsdp) |" in got
    assert port.PEAK == ref_report.PEAK


def test_report_creates_and_updates_its_target(records, tmp_path, monkeypatch):
    """The reference's create, idempotence and prose test on the port's
    report: a missing target is seeded with the header and the mark, a
    second run changes nothing, prose above the mark survives; the default
    target is the port's own file under `benchmarks/artifacts`."""
    import benchmarks.torch_report as report
    assert report.TARGET == REPO / "benchmarks" / "artifacts" / "torch_experiments.md"
    monkeypatch.setattr(report, "TARGET", tmp_path / "sub" / "torch_experiments.md")
    report.main(artifacts=records)
    target = report.TARGET
    text = target.read_text()
    assert text.startswith(report.HEADER) and report.MARK in text
    assert "not the H100's" in text and "FakeTensorMode" in text
    assert "| yi-6b | train_4k | tp_fsdp |" in text
    report.main(artifacts=records)
    assert target.read_text() == text  # idempotent
    target.write_text("# my notes\n\ncustom prose\n\n" + report.MARK + "\n")
    report.main(path=target, artifacts=records)
    out = target.read_text()
    assert out.startswith("# my notes")
    assert "custom prose" in out and report.MARK in out
    assert out.split(report.MARK)[1] == text.split(report.MARK)[1]
