"""The check against faults: a run on the CPU with the timed path broken
underneath comes out not correct, a sound run correct, and the control
(the reference in float8 in the program's place) fails the cell's limits.

Each cell's own limits (`limits/<cell>.json`, set from its runs on the
card) judge these small runs.  The exchange between chips is no fault a
one-chip cell can have."""

import copy

import pytest
import torch

from bench import check, harness, tiny
from repro_torch.models import model as M

SEED = 2 ** 31 + 4242
CELLS = ["yi6b.chat", "yi6b.rag", "mixtral.rag"]


def _stale(step):
    """A decode step that returns its cache unchanged."""
    def f(cfg, params, cache, tokens, pos, **kw):
        logits, _ = step(cfg, params, copy.deepcopy(cache), tokens, pos, **kw)
        return logits, cache
    return f


def _half(step):
    """Half of the slots left out: their rows are the other half's."""
    def f(cfg, params, cache, tokens, pos, **kw):
        logits, cache = step(cfg, params, cache, tokens, pos, **kw)
        h = logits.shape[0] // 2
        logits[h:2 * h] = logits[:h].clone()
        return logits, cache
    return f


def _altered(step):
    """Every fourth step, each slot's token replaced where it is produced."""
    n = {"calls": 0}

    def f(cfg, params, cache, tokens, pos, **kw):
        logits, cache = step(cfg, params, cache, tokens, pos, **kw)
        n["calls"] += 1
        if n["calls"] % 4 == 0:
            top = logits[:, -1].argmax(-1)
            logits[torch.arange(len(top)), -1, (top + 1) % logits.shape[-1]] = \
                logits[:, -1].max(-1).values + 1.0
        return logits, cache
    return f


def _run(name, control=False):
    cell = tiny.cell(name, n_slots=128 if name == "yi6b.chat" else 4)
    # about 16 iterations: the clock ticks a millisecond a token
    return harness.execute(cell, SEED, 16e-3 * cell.mix.n_slots, False, 0.0, device="cpu",
                           control=control, log=lambda s: None, clock=tiny.ticks())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["check"]


@pytest.mark.parametrize("fault", [_stale, _half, _altered], ids=["stale", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(monkeypatch, name, fault):
    monkeypatch.setattr(M, "serve_step", fault(M.serve_step))
    out = _run(name)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name, monkeypatch):
    seen = {}
    control = check.control_readings

    def keep(*a):
        seen.update(control(*a))
        return seen
    monkeypatch.setattr(check, "control_readings", keep)
    _run(name, control=True)
    judged = check.judge(seen, check.load_limits(tiny.ROOT, name))
    assert any(v["value"] > v["limit"] for v in judged.values()), judged
