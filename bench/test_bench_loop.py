"""The traffic and the stamp hook: the closed loop on the CPU batcher."""

from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from bench import e2e, harness, tiny, weights
from bench.generator import Mix, Stream, quantiles
from bench.loops.closed import ClosedLoop, Served

SEED = 2 ** 31 + 12345          # seeds may pass 32 signed bits


@pytest.fixture(scope="module")
def served():
    """A closed loop of 4 slots on a small dense model, stopped by its window."""
    from repro_torch.serve.engine import ContinuousBatcher

    cell = tiny.cell()
    cfg = harness.model_config(cell.conf)
    params = weights.draw(cfg, SEED, torch.device("cpu"), None)
    b = ContinuousBatcher(cfg, params, n_slots=cell.mix.n_slots, max_len=cell.mix.max_len,
                          prompt_bucket=cell.mix.prompt_bucket, device="cpu")
    loop = ClosedLoop(b, Stream(cell.mix, cfg.vocab, SEED), seconds=0.05, clock=tiny.ticks())
    loop.run()
    return loop


def test_concurrency_stays_at_slots(served):
    per_iter = Counter(it for s in served.served for it in s.iters)
    assert served.close_iter >= 3
    assert all(per_iter[it] == served.batcher.n_slots for it in range(1, served.close_iter + 1))
    assert not served.batcher.queue


def test_stamps_are_monotonic(served):
    for s in served.served:
        assert s.stamps == sorted(s.stamps)
        assert all(s.submitted <= t for t in s.stamps)
    order = sorted((t, it) for s in served.served for t, it in zip(s.stamps, s.iters))
    assert [it for _, it in order] == sorted(it for _, it in order)


def test_window_stops_without_a_drain(served):
    b = served.batcher
    assert all(r is not None for r in b.slot_req)
    assert any(not r.out.served.finished for r in b.slot_req)
    assert served.t_start < served.t_stop
    # the closing iteration's tokens are the last in the window; the one
    # after it was decoded but appended nothing
    assert max(it for s in served.served for it in s.iters) == served.close_iter
    assert b.stats["decode_iters"] == served.close_iter + 1
    assert served.t_stop - served.t_start >= served.seconds


def _lengths(seed, rounds=3):
    """Each client's first `rounds` requests: (prompt length, output)."""
    m = tiny.mix()
    st = Stream(m, 512, seed)
    return [[(len(d.prompt), d.max_new) for d in (st.next(c) for _ in range(rounds))]
            for c in range(m.n_slots)]


def test_seed_gives_the_lengths():
    assert _lengths(SEED) == _lengths(SEED)
    assert _lengths(SEED) != _lengths(SEED + 1)
    st_a, st_b = Stream(tiny.mix(), 512, SEED), Stream(tiny.mix(), 512, SEED + 1)
    assert st_a.next(0).prompt != st_b.next(0).prompt


def test_every_seed_gets_the_same_work():
    """The seed assigns the script's sequences to the clients: the same
    sequences for every seed, each block of the script the mix's
    quantiles (the first requests' outputs residual shares)."""
    assert sorted(_lengths(0)) == sorted(_lengths(7)) == sorted(_lengths(SEED))
    m = tiny.mix(n_slots=8)
    st = Stream(m, 512, SEED)
    rows = [[st.next(c) for c in range(m.n_slots)] for _ in range(3)]
    assert sorted(len(d.prompt) for d in rows[0]) == quantiles(m.prompt, m.block).tolist()
    assert sorted(d.max_new for d in rows[1]) == quantiles(m.output, m.block).tolist()
    assert all(1 <= a.max_new <= max(quantiles(m.output, m.block)) for a in rows[0])


SERVE = {"n_slots": 64, "max_len": 4096, "prompt_bucket": 128}


def test_buckets_cover_the_mix():
    m = Mix.load(tiny.ROOT / "bench" / "traffic" / "rag.json", SERVE)
    assert (m.loop, m.n_slots, m.max_len) == ("closed", 64, 4096)
    assert m.buckets()[0] == 128 and m.buckets()[-1] == 3584
    assert m.bucket_of(3584) == 3584 and m.bucket_of(1025) == 1024 and m.bucket_of(1026) == 1152


@pytest.mark.parametrize("name", ["chat", "rag"])
def test_a_mix_that_does_not_fit_is_refused(name):
    Mix.load(tiny.ROOT / "bench" / "traffic" / f"{name}.json", SERVE)
    with pytest.raises(ValueError, match="does not fit"):
        Mix.load(tiny.ROOT / "bench" / "traffic" / f"{name}.json", dict(SERVE, max_len=2048))


def test_metrics_by_hand():
    """Two requests and known stamps; the window is iterations 2 .. 3."""
    loop = SimpleNamespace(t_start=10.0, t_stop=12.0, close_iter=3)
    loop.in_window = lambda it: 2 <= it <= 3
    a = Served(client=0, prompt=[1, 2], max_new=3, submitted=9.0, submit_iter=0,
               stamps=[9.5, 11.0, 12.0], iters=[1, 2, 3])          # first token before
    b = Served(client=1, prompt=[1, 2], max_new=2, submitted=9.5, submit_iter=1,
               stamps=[11.0, 11.8], iters=[2, 3])
    c = Served(client=0, prompt=[1, 2], max_new=4, submitted=12.0, submit_iter=3,
               stamps=[12.5], iters=[4])                           # after the window
    loop.served = [a, b, c]
    m = e2e.metrics(loop)
    assert m["out_tok_s"] == pytest.approx(4 / 2.0)                 # 11.0, 12.0, 11.0, 11.8
    assert m["ttft_p90_ms"] == pytest.approx(1500.0)                # b alone: 11.0 - 9.5
    # tpot: a (12.0 - 9.5) / 2 = 1.25, b 0.8; p90 interpolates 0.8 + 0.9 * 0.45
    assert m["tpot_p90_ms"] == pytest.approx((0.8 + 0.9 * 0.45) * 1e3)
    assert e2e.sample_counts(loop) == {"out_tok_s": 4, "ttft_p90_ms": 1, "tpot_p90_ms": 2}
