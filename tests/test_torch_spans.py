"""The serving path's profiler ranges, request stamps and phase timers, on
the CPU: a small photonic yi-6b (128-wide products, so that a 128-token
prefill takes the banked quantisation and every other call the per-column
one) served by `ContinuousBatcher` under `torch.profiler`.

Ranges (`repro_torch.spans.span`): `batcher.admit` once an admission,
`batcher.decode` and `batcher.emit` once a decode step, `attention.decode`
once a layer of a decode step and never in a prefill, `photonic.quantize`
once a per-column `photonic_matmul` call or a banked one that misses the
kept levels, none on a hit, with no product inside it; none constructed
without a profiler.  Stamps: submitted <= admitted <= the first token's
append, on the host clock and, on the card's path, from the admission's
event.  Timers: the card's event pairs (fakes here, on the host clock)
are read after each decode step's copy to the host and never synchronise
the card."""

import dataclasses
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_map

from repro_torch import configs as C
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.serve.engine import ContinuousBatcher

WIDTHS = dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256,
              vocab=512)
# a 129-token prompt prefills 128 positions: the banked path, which the
# second such prompt finds quantised; the rest and every decode step (M = 2
# slots) take the per-column path
PROMPTS = [129, 9, 20, 5, 129]
MAX_NEWS = [3, 4, 2, 5, 2]
N_SLOTS, MAX_LEN, BUCKET = 2, 176, 16
PRODUCTS = ("aten::mm", "aten::matmul", "aten::bmm", "aten::addmm", "test.mac")


def _model():
    cfg = dataclasses.replace(C.get("yi_6b"), **WIDTHS, use_photonic_mac=True,
                              use_kernels=True)
    return cfg, M.init(cfg, seed=0, device="cpu")


class _Stamps(list):
    """A request's `out` that keeps the host clock of each append."""

    def __init__(self):
        super().__init__()
        self.at = []

    def append(self, tok):
        self.at.append(time.perf_counter())
        super().append(tok)


def _submit(b, cfg):
    gen = torch.Generator().manual_seed(1)
    reqs = [b.submit(torch.randint(2, cfg.vocab, (n,), generator=gen).tolist(), m)
            for n, m in zip(PROMPTS, MAX_NEWS)]
    for r in reqs:
        r.out = _Stamps()
    return reqs


def _serve(cfg, params):
    b = ContinuousBatcher(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN, prompt_bucket=BUCKET,
                          device="cpu")
    reqs = _submit(b, cfg)
    b.run()
    return b, reqs


def _assert_stamps_ordered(reqs):
    for r in reqs:
        assert r.done and len(r.out) == r.max_new
        assert r.submitted <= r.admitted <= r.out.at[0]
    # one slot fewer than requests: the later ones waited for a slot
    assert max(r.admitted - r.submitted for r in reqs) > 0


def _ancestors(e):
    out = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        out.append(e.name)
    return out


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(1)
    return _model()


@pytest.fixture(scope="module")
def traced(model):
    """One traced run, each `photonic_matmul` call counted by its path (a
    banked call as a hit or a miss of the kept levels) and each product of
    the photonic linear under a `test.mac` range.  On a copy of the
    parameters, so that no earlier run has kept their levels."""
    cfg, params = model
    params = tree_map(torch.clone, params)
    calls = {"tiled": 0, "miss": 0, "column": 0}
    impl, mac = ops._photonic_fwd_impl, ops._mac

    def counting(x, w, *args):
        tiled = ops.uses_tiled_path(x.shape[0], *w.shape)
        calls["tiled" if tiled else "column"] += 1
        misses = ops.photonic_matmul.quant_misses
        out = impl(x, w, *args)
        calls["miss"] += ops.photonic_matmul.quant_misses - misses
        return out

    def ranged_mac(*a):
        with torch.profiler.record_function("test.mac"):
            return mac(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_photonic_fwd_impl", counting)
        mp.setattr(ops, "_mac", ranged_mac)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            b, reqs = _serve(cfg, params)
    return b, reqs, list(prof.events()), calls


def _named(events, name):
    return [e for e in events if e.name == name]


def test_batcher_ranges_once_per_admission_and_step(traced):
    b, reqs, events, _ = traced
    assert b.stats["prefill_calls"] == len(reqs)
    assert len(_named(events, "batcher.admit")) == b.stats["prefill_calls"]
    assert len(_named(events, "batcher.decode")) == b.stats["decode_iters"]
    assert len(_named(events, "batcher.emit")) == b.stats["decode_iters"]
    # the decode step's range holds the step, not the admissions before it
    assert all("batcher.admit" not in _ancestors(e) for e in _named(events, "batcher.decode"))


def test_decode_attention_once_per_layer_of_a_decode_step(traced):
    b, _, events, _ = traced
    dec = _named(events, "attention.decode")
    assert len(dec) == b.cfg.n_layers * b.stats["decode_iters"]
    for e in dec:
        up = _ancestors(e)
        assert "attention" in up and "batcher.decode" in up and "batcher.admit" not in up
    # the new token's K and V are written into the cache outside the range
    writes = [e for e in events if e.name == "aten::index_put_"
              and "batcher.decode" in _ancestors(e) and "attention" in _ancestors(e)]
    assert len(writes) >= 2 * len(dec)
    assert not any("attention.decode" in _ancestors(e) for e in writes)
    # prefills run attention, never its decode range
    admits = [e for e in events if "batcher.admit" in _ancestors(e)]
    assert any(e.name == "attention" for e in admits)
    assert not any(e.name == "attention.decode" for e in admits)


def test_quantize_once_per_photonic_matmul_without_the_product(traced):
    _, _, events, calls = traced
    assert calls["tiled"] > 0 and calls["column"] > 0        # both paths taken
    # the first banked prefill quantises each weight, the second takes its levels
    assert 0 < calls["miss"] == calls["tiled"] - calls["miss"]
    quant = _named(events, "photonic.quantize")
    assert len(quant) == calls["miss"] + calls["column"]
    assert len(_named(events, "test.mac")) == calls["tiled"]
    inside = [e.name for e in events if "photonic.quantize" in _ancestors(e)]
    assert inside and not any(n in PRODUCTS for n in inside)
    # the per-column path's product follows its range in the same call
    assert any(e.name in PRODUCTS for e in events if "photonic.quantize" not in _ancestors(e))


def test_request_stamps_are_ordered(traced):
    _, reqs, _, _ = traced
    _assert_stamps_ordered(reqs)


def test_tracing_changes_neither_tokens_nor_counts(model, traced):
    b_traced, reqs_traced, _, _ = traced
    b, reqs = _serve(*model)
    assert [r.out for r in reqs] == [r.out for r in reqs_traced]
    counts = ("decode_iters", "decode_tokens", "prefill_calls", "prefill_tokens")
    assert {k: b.stats[k] for k in counts} == {k: b_traced.stats[k] for k in counts}
    assert b.stats["decode_tokens"] == sum(MAX_NEWS)
    plens = [max(BUCKET, -(-(n - 1) // BUCKET) * BUCKET) for n in PROMPTS]
    assert b.stats["prefill_tokens"] == sum(plens)
    assert b.stats["prefill_s"] > 0 and b.stats["decode_s"] > 0
    assert set(b.stats) == {"decode_iters", "decode_tokens", "decode_s", "prefill_calls",
                            "prefill_tokens", "prefill_s"}


def test_no_range_is_constructed_without_a_profiler(model, monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) constructed with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    b, reqs = _serve(*model)
    assert all(r.done for r in reqs)


class _FakeEvent:
    """A CUDA event on the host clock: `record` stamps it, `elapsed_time`
    gives milliseconds, as `torch.cuda.Event` does."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_card_timers_read_events_after_the_copy_and_never_synchronise(model, monkeypatch):
    """The card's path on the CPU: fake events, a stream of none, and a
    `synchronize` that fails the test.  The pairs are read after each
    decode step, before its tokens are handed out, and reused; each
    admission's stamp is read from its event then."""
    cfg, params = model
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)

    def refuse(*a, **k):
        raise AssertionError("the batcher synchronised the card")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    _FakeEvent.made = 0
    b = ContinuousBatcher(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN, prompt_bucket=BUCKET,
                          device="cpu")
    b._card = True
    seen = []
    settle = b._settle

    stamped = []

    def watched(now, end):
        pending = [r for r, _ in b._admits]
        assert all(r.admitted is None for r in pending)
        settle(now, end)
        assert all(r.admitted is not None for r in pending)
        stamped.extend(pending)
        seen.append((dict(b.stats), len(b._laps) + len(b._admits)))
    b._settle = watched
    reqs = _submit(b, cfg)
    b.run()
    assert all(r.done for r in reqs) and not b._laps and not b._admits
    assert sorted(r.rid for r in stamped) == [r.rid for r in reqs]
    _assert_stamps_ordered(reqs)
    assert len(seen) == b.stats["decode_iters"]
    # each step's seconds are in `stats` before its step is counted
    assert all(st["decode_s"] > 0 and lap == 0 for st, lap in seen)
    assert seen[0][0]["decode_iters"] == 0 and seen[0][0]["prefill_s"] > 0
    assert b.stats["prefill_s"] > 0 and b.stats["decode_s"] > 0
    # at most three events an admission (its start, its prefill's pair) and
    # a pair for the step, all from the pool
    assert _FakeEvent.made <= 3 * N_SLOTS + 2
    assert len(b._events) == _FakeEvent.made
