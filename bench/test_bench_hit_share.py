"""The reader of the photonic linear's own counters:
`dispatch.quantize_hit_share` from `photonic_matmul.quant_hits` and
`.quant_misses`, None where the program has no such counter or made no
banked call."""

import dataclasses

import pytest

from bench import harness, tiny
from repro_torch.kernels import ops

SEED = 2 ** 31 + 777


def _read(name, run):
    return harness.read_metric(tiny.ROOT, name)(run)


def test_hit_share_from_hand_set_counters(monkeypatch):
    monkeypatch.setattr(ops.photonic_matmul, "quant_hits", 297)
    monkeypatch.setattr(ops.photonic_matmul, "quant_misses", 3)
    assert _read("dispatch.quantize_hit_share", harness.Run(None, None, None)) == 99.0
    monkeypatch.setattr(ops.photonic_matmul, "quant_hits", 0)
    assert _read("dispatch.quantize_hit_share", harness.Run(None, None, None)) == 0.0
    monkeypatch.setattr(ops.photonic_matmul, "quant_misses", 0)      # no banked call yet
    assert _read("dispatch.quantize_hit_share", harness.Run(None, None, None)) is None


@pytest.mark.parametrize("counter", ["quant_hits", "quant_misses"])
def test_hit_share_without_its_counters_reads_nothing(monkeypatch, counter):
    """A program whose photonic linear keeps no levels (the counter gone)."""
    monkeypatch.delattr(ops.photonic_matmul, counter)
    assert _read("dispatch.quantize_hit_share", harness.Run(None, None, None)) is None


def test_a_traced_banked_tiny_run_reports_the_hit_share():
    """The tiny cell with its prompts bucketed to 128, so that its prefills
    take the banked path: the traced line reads the hit share, below 100 %
    (each weight's first call is a miss) and above 0."""
    cell = dataclasses.replace(tiny.cell(), mix=tiny.mix(prompt_bucket=128))
    out = harness.execute(cell, SEED, 0.05, True, 0.0, device="cpu", log=lambda s: None,
                          clock=tiny.ticks())
    m = out["metrics"]
    assert 0 < m["dispatch.quantize_hit_share"]["value"] < 100
    assert m["dispatch.quantize_hit_share"]["unit"] == "%"
    assert out["correct"]
