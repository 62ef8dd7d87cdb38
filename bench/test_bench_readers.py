"""The readers of the program's own ranges and stamps: `dispatch.quantize_share`
and `attention.decode_share` from a span's `ranges`, and
`batcher.admit_wait_p90_ms` from the requests' `submitted` and `admitted`
stamps, each None where the program has no such range or stamp."""

from types import SimpleNamespace

import pytest
import torch

from bench import e2e, harness, tiny, trace, weights
from bench.generator import Stream
from bench.loops.closed import ClosedLoop

SEED = 2 ** 31 + 777
SHARES = {"dispatch.quantize_share": "photonic.quantize",
          "attention.decode_share": "attention.decode"}


def _read(name, run):
    return harness.read_metric(tiny.ROOT, name)(run)


def _span(ranges):
    return trace.SpanResult(busy_s=2.0, window_s=4.0, kernels={}, calls={}, ranges=ranges,
                            breakdown={})


def test_shares_from_a_hand_built_span():
    run = harness.Run(cell=None, loop=None,
                      span=_span({"photonic.quantize": 0.5, "attention.decode": 0.25,
                                  "attention": 0.75}))
    assert _read("dispatch.quantize_share", run) == pytest.approx(25.0)
    assert _read("attention.decode_share", run) == pytest.approx(12.5)


@pytest.mark.parametrize("name", sorted(SHARES))
def test_a_share_without_its_range_reads_nothing(name):
    others = {r: 0.5 for r in SHARES.values() if r != SHARES[name]}
    assert _read(name, harness.Run(cell=None, loop=None, span=_span(dict(others)))) is None
    assert _read(name, harness.Run(cell=None, loop=None, span=None)) is None
    assert _read(name, harness.Run(cell=None, loop=None, span=_span({SHARES[name]: 0.0}))) == 0.0


@pytest.fixture(scope="module")
def loop():
    """The tiny closed loop: 4 slots, stopped by its window."""
    from repro_torch.serve.engine import ContinuousBatcher

    cell = tiny.cell()
    cfg = harness.model_config(cell.conf)
    params = weights.draw(cfg, SEED, torch.device("cpu"), None)
    b = ContinuousBatcher(cfg, params, n_slots=cell.mix.n_slots, max_len=cell.mix.max_len,
                          prompt_bucket=cell.mix.prompt_bucket, device="cpu")
    lp = ClosedLoop(b, Stream(cell.mix, cfg.vocab, SEED), seconds=0.05, clock=tiny.ticks())
    lp.run()
    return lp


def test_admit_wait_from_the_tiny_closed_loop(loop):
    ttft = [s for s in loop.served if s.iters and loop.in_window(s.iters[0])]
    assert len(ttft) == e2e.sample_counts(loop)["ttft_p90_ms"] > 0
    waits = [s.request.admitted - s.request.submitted for s in ttft]
    assert all(w >= 0 for w in waits)
    got = _read("batcher.admit_wait_p90_ms", harness.Run(cell=None, loop=loop, span=None))
    assert got == pytest.approx(e2e.p90(waits) * 1e3)


def test_admit_wait_without_stamps_reads_nothing(loop):
    """A program whose `Request` carries no stamps (the loop's requests
    replaced by ones with tokens alone)."""
    bare = SimpleNamespace(
        served=[SimpleNamespace(iters=s.iters, request=SimpleNamespace(out=list(s.tokens)))
                for s in loop.served],
        in_window=loop.in_window)
    assert _read("batcher.admit_wait_p90_ms", harness.Run(cell=None, loop=bare, span=None)) is None


def test_a_traced_tiny_run_reports_the_wait():
    """Through the harness: the traced line reads the wait; on the CPU the
    trace holds no device operation, so the shares read nothing and are
    left out of the line."""
    cell = tiny.cell()
    out = harness.execute(cell, SEED, 0.05, True, 0.0, device="cpu", log=lambda s: None,
                          clock=tiny.ticks())
    m = out["metrics"]
    assert m["batcher.admit_wait_p90_ms"]["value"] >= 0
    assert m["batcher.admit_wait_p90_ms"]["unit"] == "ms"
    assert not set(SHARES) & set(m)
    assert out["correct"]
