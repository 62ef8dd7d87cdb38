"""The plain reference against the port on the CPU, on small cells of both
families: the prefill call's logits, and what a served window produced
(each served token's gap and one further decode step's logits).

In f32 the two compute the same arithmetic in other orders (the kernels'
plain versions on the CPU, the reference's products on whole weights), so
the logits agree to 1e-4 of the largest: far below what any step of the
model, a quantisation or a routing choice, would change.  In bf16, as the
cells run, the dense model's readings stay within its cells' limits."""

import dataclasses

import pytest
import torch

from bench import check, harness, tiny, weights
from repro_torch.models import model as M


@pytest.mark.parametrize("name", ["yi6b.chat", "mixtral.rag"])
@pytest.mark.parametrize("length", [128, 40])
def test_prefill_logits_f32(name, length):
    cell = tiny.cell(name, dtype="float32")
    cfg = harness.model_config(cell.conf)
    params = weights.draw(cfg, 11, torch.device("cpu"),
                          harness.DTYPES[cell.conf["expert_dtype"]])
    toks = torch.randint(1, cfg.vocab, (1, length), generator=torch.Generator().manual_seed(1))
    port, _ = M.prefill(cfg, params, {"tokens": toks}, cache_len=length + 1, device="cpu")
    ref = check.reference(cell.conf["reference"])
    seq = ref.Seq(prefill=toks[0].tolist(), n_real=length, decode=[], m_prefill=length,
                  m_decode=cell.mix.n_slots)
    _, pre = ref.forward(cell.conf, params, [seq], prefill_logits=True)
    want = pre[0][0]
    assert (port[0, -1] - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("name", ["yi6b.chat", "mixtral.rag"])
@pytest.mark.parametrize("slots", [4, 128])
def test_served_window_f32(name, slots):
    cell = tiny.cell(name, n_slots=slots, dtype="float32")
    seen = {}
    readings = check.readings

    def keep(*a):
        seen.update(readings(*a))
        return seen
    mp = pytest.MonkeyPatch()
    mp.setattr(check, "readings", keep)
    try:
        harness.execute(cell, 2 ** 33 + 1, 12e-3 * slots, False, 0.0, device="cpu",
                        log=lambda s: None, clock=tiny.ticks())
    finally:
        mp.undo()
    assert seen["gap"] <= 1e-4 and seen["step_err"] <= 1e-4, seen
    if cell.conf["family"] == "moe":      # the shadow row follows the same choices
        assert seen["step_err_routed"] <= 1e-4, seen


def test_shadow_row_follows_the_given_experts():
    """A shadow of the step's row given the reference's own experts computes
    the step's logits again; given others, other logits."""
    cell = tiny.cell("mixtral.rag", dtype="float32")
    cfg = harness.model_config(cell.conf)
    params = weights.draw(cfg, 5, torch.device("cpu"), harness.DTYPES[cell.conf["expert_dtype"]])
    ref = check.reference(cell.conf["reference"])
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(1, cfg.vocab, (40,), generator=g).tolist()
    seq = ref.Seq(prefill=toks[:32], n_real=30, decode=toks[32:], m_prefill=32, m_decode=4)
    probs: list = []
    plain = ref.forward(cell.conf, params, [seq], routes=probs)[0]
    own = ref.top_k(probs[0], cfg.top_k)[1]
    same = ref.forward(cell.conf, params, [dataclasses.replace(seq, force=own)])[0]
    assert torch.equal(same[:-1], plain)
    assert (same[-1] - plain[-1]).abs().max() <= 1e-5 * plain[-1].abs().max()
    other = ref.forward(cell.conf, params, [dataclasses.replace(seq, force=own.flip(0))])[0]
    assert torch.equal(other[:-1], plain)
    assert (other[-1] - plain[-1]).abs().max() > 1e-2 * plain[-1].abs().max()


def test_route_readings_by_hand():
    probs = [torch.tensor([[0.5, 0.3, 0.15, 0.05],       # own (0, 1)
                           [0.4, 0.3, 0.29, 0.01],       # own (0, 1); chosen (0, 2): first flip
                           [0.7, 0.2, 0.05, 0.05]])]     # own (0, 1); chosen (2, 3)
    chosen = [torch.tensor([[1, 0], [0, 2], [2, 3]])]
    r = check.route_readings(probs, chosen, 2)
    assert r["flips"] == 2
    assert r["flip_margin"] == pytest.approx(0.7 - 0.69, abs=1e-6)  # the first flip's, not the later 0.8
