"""The port's training runtime on the CPU: fault tolerance, checkpoints,
data determinism and straggler accounting (the counterparts of the
reference's `tests/test_runtime.py` and `tests/test_data_and_ckpt.py`), and
against the reference: `SyntheticLM` and `TokenFileSource` batches array
for array, and checkpoints that each package writes restored by the other.
"""

import concurrent.futures
import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# `repro.runtime.trainer` imports `repro.core.fabric`, whose power model
# imports `jax.experimental.enable_x64`; newer jax only has `jax.enable_x64`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from repro import configs as JC  # noqa: E402
from repro.checkpoint import store as JS  # noqa: E402
from repro.data import filesource as JF  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.checkpoint.async_store import AsyncCheckpointer  # noqa: E402
from repro_torch.data.filesource import TokenFileSource  # noqa: E402
from repro_torch.data.pipeline import DataConfig, DeadlineMonitor, Prefetcher, SyntheticLM  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import state_from_reference  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.trainer import (FailureInjected, Trainer, TrainerConfig,  # noqa: E402
                                         run_with_restarts)

CFG = C.get_reduced("yi_6b")
OPT = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=16)
DATA = DataConfig(global_batch=2, seq_len=64)


@pytest.fixture(scope="module", autouse=True)
def _low_cpu_priority():
    """This module compiles and runs both packages for minutes of CPU time;
    it runs at a lower scheduling priority so that timing-gated tests that
    share the machine (the benchmark smoke tests' ratio bars) keep theirs.
    The priority is restored where the process may raise it again."""
    os.nice(10)
    yield
    try:
        os.nice(-10)
    except PermissionError:
        pass


def _trainer(tmp, resume=True, **kw):
    return Trainer(CFG, OPT, DATA, TrainerConfig(ckpt_dir=str(tmp), ckpt_every=2, log_every=1000),
                   resume=resume, device="cpu", **kw)


def _leaves(state):
    return [x.numpy() for x in T.leaves(state)]


def test_resume_bitwise_identical(tmp_path):
    """Crash at step 4 + restart == uninterrupted run (bitwise)."""
    t_straight = _trainer(tmp_path / "a", resume=False)
    t_straight.run(6, quiet=True)
    t_crash = run_with_restarts(lambda: _trainer(tmp_path / "b"), total_steps=6, fail_at=(4,))
    for x, y in zip(_leaves(t_straight.state), _leaves(t_crash.state)):
        np.testing.assert_array_equal(x, y)


def test_checkpoint_atomicity_and_retention(tmp_path):
    t = _trainer(tmp_path, resume=False)
    t.run(8, quiet=True)
    assert store.latest_step(tmp_path) == 8
    kept = sorted(d.name for d in tmp_path.iterdir() if d.name.startswith("step_"))
    assert kept == ["step_00000004", "step_00000006", "step_00000008"]  # retention: 3
    assert not any(d.name.endswith(".tmp") for d in tmp_path.iterdir())
    assert all("ckpt_s" in h for h in t.history if h["step"] % 2 == 0)


def test_checkpoint_corruption_detected_and_walked_back(tmp_path):
    t = _trainer(tmp_path, resume=False)
    t.run(4, quiet=True)
    ck = tmp_path / "step_00000004"
    victim = next(ck.glob("leaf_*.npy"))
    victim.write_bytes(b"corrupted!" + victim.read_bytes()[10:])
    with pytest.raises(IOError, match="corruption"):
        store.restore(tmp_path, 4, t.state)
    # a fresh trainer drops the corrupt step and resumes from step 2
    t2 = _trainer(tmp_path)
    assert t2.start_step == 2 and not ck.exists()
    assert int(t2.state.step) == 2


def test_restore_refuses_another_structure(tmp_path):
    t = _trainer(tmp_path, resume=False)
    t.run(2, quiet=True)
    other = adamw.init_state(OPT, M.init(C.get_reduced("zamba2_1p2b"), device="cpu"))
    with pytest.raises(store.StructureMismatch):
        store.restore(tmp_path, 2, other)
    assert store.latest_step(tmp_path) == 2          # not taken for a corruption


def test_restore_roundtrip_is_exact(tmp_path):
    t = _trainer(tmp_path, resume=False)
    t.run(2, quiet=True)
    restored = store.restore(tmp_path, 2, t.state)
    for x, y in zip(_leaves(t.state), _leaves(restored)):
        np.testing.assert_array_equal(x, y)


def test_bf16_state_roundtrip(tmp_path):
    """bf16 moments are stored as their bits, "bfloat16" in the manifest."""
    opt = dataclasses.replace(OPT, state_dtype="bfloat16")
    t = Trainer(CFG, opt, DATA, TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2),
                resume=False, device="cpu")
    t.run(2, quiet=True)
    restored = store.restore(tmp_path, 2, t.state)
    for x, y in zip(T.leaves(t.state), T.leaves(restored)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert T.leaves(restored.m)[0].dtype == torch.bfloat16


def test_data_step_indexed_determinism():
    src = SyntheticLM(CFG, DATA)
    b1, b2, b3 = src.batch_at(7), src.batch_at(7), src.batch_at(8)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_data_host_sharding_disjoint():
    d = DataConfig(global_batch=4, seq_len=32)
    h0 = SyntheticLM(CFG, d, host_index=0, host_count=2).batch_at(0)
    h1 = SyntheticLM(CFG, d, host_index=1, host_count=2).batch_at(0)
    assert h0["tokens"].shape == (2, 32)
    assert not np.array_equal(h0["tokens"], h1["tokens"])


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_synthetic_batches_equal_the_reference(arch):
    """Every array of `batch_at`, M-RoPE positions, pixel embeddings and
    encoder frames included, for the reduced config and the published one."""
    for cfg, jcfg in ((C.get_reduced(arch), JC.get_reduced(arch)), (C.get(arch), JC.get(arch))):
        for step in (0, 5):
            got = SyntheticLM(cfg, DataConfig(2, 32, seed=3)).batch_at(step)
            want = JP.SyntheticLM(jcfg, JP.DataConfig(2, 32, seed=3)).batch_at(step)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_yields_in_order():
    src = SyntheticLM(CFG, DATA)
    pf = Prefetcher(iter(src), depth=2)
    np.testing.assert_array_equal(next(pf)["tokens"], src.batch_at(0)["tokens"])
    np.testing.assert_array_equal(next(pf)["tokens"], src.batch_at(1)["tokens"])
    pf.close()


def test_straggler_deadline_accounting():
    mon = DeadlineMonitor(deadline_s=0.5)
    assert mon.admit(0.1)
    assert not mon.admit(0.9)
    assert mon.stats.steps == 2 and mon.stats.dropped == 1
    assert mon.stats.drop_rate == pytest.approx(0.5)
    assert mon.survivor_scale(16, 1) == pytest.approx(16 / 15)


def test_straggler_drop_skips_the_step(tmp_path):
    t = Trainer(CFG, OPT, DATA, TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                                              straggler_deadline_s=-1.0),
                resume=False, device="cpu")
    out = t.run(2, quiet=True)
    assert t.history == [] and out["straggler"]["dropped"] == 2
    assert int(t.state.step) == 0


def test_failure_injection_raises(tmp_path):
    t = _trainer(tmp_path, resume=False)
    with pytest.raises(FailureInjected):
        t.run(6, fail_at=2, quiet=True)
    assert store.latest_step(tmp_path) == 2      # the checkpoint from before the failure


@pytest.fixture
def corpus(tmp_path):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(0).integers(0, 2 * CFG.vocab, size=100_000, dtype=np.uint16).tofile(path)
    return path


def test_tokenfile_source_matches_reference(corpus):
    """Shapes, step determinism, next-token labels, the vocabulary clamp,
    disjoint hosts whose union is the global batch, and the reference's
    arrays."""
    d = DataConfig(global_batch=4, seq_len=64)
    src = TokenFileSource(CFG, d, corpus)
    b1, b2, b3 = src.batch_at(3), src.batch_at(3), src.batch_at(4)
    assert b1["tokens"].shape == (4, 64)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert int(b1["tokens"].max()) < CFG.vocab
    hosts = [TokenFileSource(CFG, d, corpus, host_index=i, host_count=2).batch_at(3)
             for i in range(2)]
    assert not np.array_equal(hosts[0]["tokens"], hosts[1]["tokens"])
    np.testing.assert_array_equal(np.concatenate([h["tokens"] for h in hosts]), b1["tokens"])
    want = JF.TokenFileSource(JC.get_reduced("yi_6b"), JP.DataConfig(4, 64), corpus).batch_at(3)
    for k in want:
        np.testing.assert_array_equal(b1[k], want[k])


def test_async_checkpoint_roundtrip(tmp_path):
    tree = {"w": torch.arange(100, dtype=torch.float32), "b": torch.ones(7)}
    ck = AsyncCheckpointer(tmp_path, keep=2)
    futs = [ck.save(s, T.map_structure(lambda x: x + s, tree)) for s in (1, 2, 3)]
    ck.wait()
    assert all(isinstance(f, concurrent.futures.Future) and f.done() for f in futs)
    assert store.latest_step(tmp_path) == 3
    restored = store.restore(tmp_path, 3, tree)
    np.testing.assert_allclose(restored["w"].numpy(), np.arange(100, dtype=np.float32) + 3)
    assert len([d for d in tmp_path.iterdir() if d.name.startswith("step_")]) <= 2
    ck.close()


def test_async_checkpoint_snapshot_isolation(tmp_path):
    """Changing the state in place right after save() must not reach the
    written checkpoint: the host snapshot is taken synchronously."""
    x = torch.zeros(1000)
    ck = AsyncCheckpointer(tmp_path)
    ck.save(1, {"x": x})
    x.add_(999.0)
    ck.wait()
    restored = store.restore(tmp_path, 1, {"x": x})
    np.testing.assert_array_equal(restored["x"].numpy(), np.zeros(1000))
    ck.close()


def _ref_state(arch, state_dtype="float32"):
    """The reference's state after one update on made-up gradients (so that
    m, v and the step are not zero)."""
    jcfg = JC.get_reduced(arch)
    jopt = JA.OptConfig(state_dtype=state_dtype)

    def make(key):
        jparams, _ = JM.init(jcfg, key)
        grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), jparams)
        return JA.apply_updates(jopt, JA.init_state(jopt, jparams), grads)
    return jax.jit(make)(jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "seamless_m4t_medium"])
def test_f32_checkpoints_cross_between_the_packages(tmp_path, arch):
    """The reference's checkpoint restores in the port and the port's in the
    reference: the same leaf names (`jax.tree_util.keystr`), files and
    values."""
    cfg = C.get_reduced(arch)
    jstate = _ref_state(arch)
    state = state_from_reference(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    JS.save(tmp_path / "ref", 1, jstate)
    store.save(tmp_path / "port", 1, state)
    want = {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(jstate)}
    assert [n for n, _ in T.leaves_with_path(state)] == list(want)
    from_ref = store.restore(tmp_path / "ref", 1, state)
    for name, leaf in T.leaves_with_path(from_ref):
        np.testing.assert_array_equal(leaf.numpy(), want[name])
    from_port = JS.restore(tmp_path / "port", 1, jstate)
    for kp, v in jax.tree_util.tree_leaves_with_path(from_port):
        name = jax.tree_util.keystr(kp)
        assert v.dtype == want[name].dtype, name
        np.testing.assert_array_equal(np.asarray(v), want[name])


def test_port_reads_the_references_bf16_checkpoint(tmp_path):
    """The reference stores a bf16 leaf as 2-byte void records ("bfloat16"
    in its manifest); the port reads those as it reads its own uint16
    bits.  (The reference cannot read either back: ROADMAP.md, Queue 3.)"""
    cfg = C.get_reduced("zamba2_1p2b")
    jstate = _ref_state("zamba2_1p2b", "bfloat16")
    JS.save(tmp_path, 1, jstate)
    state = state_from_reference(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    assert T.leaves(state.m)[0].dtype == torch.bfloat16
    restored = store.restore(tmp_path, 1, state)
    for x, y in zip(T.leaves(state), T.leaves(restored)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_launch_train_main_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "64", "--ckpt", str(tmp_path), "--ckpt-every", "2",
            "--photonic-mac"]
    trainer, out = launch_train.main(argv)
    assert out["final_step"] == 4 and np.isfinite(out["last_loss"])
    assert [h["step"] for h in trainer.history] == [1, 2, 3, 4]
    assert trainer.cfg.use_photonic_mac and not trainer.cfg.use_kernels
    assert store.retained_steps(tmp_path) == [2, 4]
    assert "done:" in capsys.readouterr().out
    # a second run to step 6 resumes at step 4
    trainer2, _ = launch_train.main(argv[:6] + ["6"] + argv[7:])
    assert trainer2.start_step == 4 and [h["step"] for h in trainer2.history] == [5, 6]


def test_launch_train_main_reads_a_token_file(tmp_path, corpus):
    trainer, out = launch_train.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                                      "--steps", "2", "--batch", "2", "--seq", "32",
                                      "--ckpt", str(tmp_path / "ck"), "--no-resume",
                                      "--data-file", str(corpus)])
    assert isinstance(trainer.source, TokenFileSource) and np.isfinite(out["last_loss"])


@pytest.mark.parametrize("flags", [["--mesh", "single"], ["--mesh", "multi"]])
def test_launch_train_refuses_what_is_not_ported(tmp_path, flags, monkeypatch):
    """`--mesh` outside torchrun (no process group, no rendezvous
    variables) raises, naming the ranks it needs."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    ranks = 512 if "multi" in flags else 256
    with pytest.raises(RuntimeError, match=f"needs {ranks} ranks: run under torchrun"):
        launch_train.main(["--arch", "yi-6b", "--reduced", "--device", "cpu", "--ckpt",
                           str(tmp_path)] + flags)


def _ref_launch_losses(monkeypatch, capsys, argv) -> list:
    """The reference launcher's per-step losses for `argv` (its `main` reads
    `sys.argv` and returns nothing: `Trainer.run` is wrapped to keep them)."""
    from repro.launch import train as ref_train
    from repro.runtime import trainer as JT
    kept = []
    run = JT.Trainer.run

    def keep(self, *a, **kw):
        out = run(self, *a, **kw)
        kept.append([h["loss"] for h in self.history])
        return out

    monkeypatch.setattr(JT.Trainer, "run", keep)
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    ref_train.main()
    capsys.readouterr()
    return kept[-1]


def test_launch_train_wire_bits_trains_as_without_it(tmp_path, monkeypatch, capsys):
    """`--wire-bits 8` without a mesh sets `cfg.wire_bits` and trains bit
    for bit as without the flag, on the port and on the reference (whose
    trainer builds its step with no wire when there is no mesh); the
    port's launcher warns that the flag changes nothing."""
    base = ["--arch", "yi-6b", "--reduced", "--steps", "2", "--batch", "2", "--seq", "32",
            "--no-resume"]
    runs = {}
    for flag in ([], ["--wire-bits", "8"]):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            trainer, _ = launch_train.main(base + ["--device", "cpu", "--ckpt",
                                                   str(tmp_path / f"port{len(flag)}")] + flag)
        assert trainer.cfg.wire_bits == (8 if flag else 0)
        assert [str(w.message) for w in seen if "--wire-bits" in str(w.message)] == (
            ["--wire-bits 8 without --mesh changes nothing: the step runs with no parameter "
             "wire and trains as without the flag"] if flag else [])
        runs[tuple(flag)] = [h["loss"] for h in trainer.history]
    assert len(runs[()]) == 2 and runs[()] == runs[("--wire-bits", "8")]
    ref = {tuple(flag): _ref_launch_losses(
        monkeypatch, capsys, base + ["--ckpt", str(tmp_path / f"ref{len(flag)}")] + flag)
        for flag in ([], ["--wire-bits", "8"])}
    assert len(ref[()]) == 2 and ref[()] == ref[("--wire-bits", "8")]


def test_trainer_refuses_mesh_fabric_and_fault_injection(tmp_path):
    """Under a mesh the parameter wire and an MoE config both go on to read
    the mesh (each trains under one: `tests/test_torch_tensor_parallel.py`,
    `tests/test_torch_sharded_train.py`), so an object that is no mesh is
    refused there; a fabric is ported, and an unknown preset name is
    refused as the reference's `get_fabric` refuses it; a fault without a
    fabric raises as the reference's does."""
    tc = TrainerConfig(ckpt_dir=str(tmp_path))
    with pytest.raises(AttributeError, match="axis_names"):     # the mesh, read
        Trainer(dataclasses.replace(CFG, wire_bits=8), OPT, DATA, tc, mesh=object(),
                resume=False, device="cpu")
    with pytest.raises(AttributeError, match="axis_names"):     # the mesh, read
        Trainer(C.get_reduced("mixtral_8x7b"), OPT, DATA, tc, mesh=object(), resume=False,
                device="cpu")
    with pytest.raises(KeyError, match="unknown fabric preset"):
        _trainer(tmp_path, fabric="trine")
    with pytest.raises(ValueError, match="no fabric"):
        _trainer(tmp_path).inject_fault(None)


def test_trainer_refuses_non_f32_masters(tmp_path):
    """Serving stores MoE experts in the compute dtype; an optimizer needs
    f32 masters, which the trainer draws itself (`expert_dtype`)."""
    cfg = dataclasses.replace(C.get_reduced("mixtral_8x7b"), dtype="bfloat16")
    params = M.init(cfg, device="cpu")
    assert params["stages"][0]["moe_0"]["moe"]["wi"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="f32 masters"):
        Trainer(cfg, OPT, DATA, TrainerConfig(ckpt_dir=str(tmp_path)), resume=False,
                device="cpu", state=adamw.init_state(OPT, params))
    t = Trainer(cfg, OPT, DATA, TrainerConfig(ckpt_dir=str(tmp_path)), resume=False,
                device="cpu")
    assert all(p.dtype == torch.float32 for p in T.leaves(t.state.params))


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(CFG, OPT, DATA, TrainerConfig(), resume=False)


def test_training_modules_import_without_jax_or_the_reference_package():
    code = (
        "import sys\n"
        "import repro_torch.optim.adamw, repro_torch.data.pipeline, repro_torch.data.filesource\n"
        "import repro_torch.checkpoint.store, repro_torch.checkpoint.async_store\n"
        "import repro_torch.runtime.trainer, repro_torch.launch.train, repro_torch.tree\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": src})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
