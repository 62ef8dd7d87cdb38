"""On the card (marked `card`; skips without one): a small cell through the
whole run, traced, with the port's kernels, so that the trace readers meet
real kernel names and the launch counts meet the wrappers' counters."""

import pytest

from bench import harness, tiny


@pytest.mark.card
def test_small_cell_traced_on_card(card):
    cell = tiny.cell("yi6b.chat", n_slots=128)
    out = harness.execute(cell, 5, 1.0, True, 0.0, device=card, log=lambda s: None)
    m = out["metrics"]
    assert out["correct"], out["check"]
    for name in ("photonic_mac.roofline", "flash_attention.roofline"):
        assert 0 < m[name]["value"] <= 105, (name, m)
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert len(out["breakdown"]["device_ops"]) <= 10
