"""The frozen counts: worked bounds, and the reckoned launches of one
prefill and one decode step against the kernels' calls on the CPU."""

import pytest
import torch

from bench import harness, tiny, weights
from bench.counts import bounds
from bench.counts import decoder as K


def test_mac_bound_worked_value():
    # 128 x 4096 x 11008 in bf16: x 1 MiB, levels 45.1 MB, scales, f32 out
    # 5.6 MB; bound by bytes (0.01546 ms) over operations (0.01167 ms)
    t = bounds.mac_bound_s(128, 4096, 11008, 2)
    assert t * 1e3 == pytest.approx(0.01546, abs=5e-6)
    assert t > 2 * 128 * 4096 * 11008 / 989e12


def test_attn_bound_worked_value():
    # B=1, Hq=32, Hk=4, S=128, D=128, causal: bound by bytes at 0.001017 ms
    t = bounds.attn_bound_s(1, 32, 4, 128, 128, 128, True, 0)
    assert t * 1e3 == pytest.approx(0.001017, abs=5e-7)
    assert bounds.attention_pairs(128, 128, True, 0, 0) == 128 * 129 // 2
    assert bounds.attention_pairs(8, 8, True, 3, 0) == 1 + 2 + 3 * 6


@pytest.fixture
def counting(monkeypatch):
    """The kernel entry points `ops` calls, counted: on the CPU they take
    the plain versions, so their `.launches` stay 0."""
    from repro_torch.kernels import ops

    n = {"photonic_mac": 0, "flash_attention": 0}

    def wrap(name, fn):
        def f(*a, **kw):
            n[name] += 1
            return fn(*a, **kw)
        return f
    monkeypatch.setattr(ops, "_mac_fwd", wrap("photonic_mac", ops._mac_fwd))
    monkeypatch.setattr(ops, "_flash_fwd", wrap("flash_attention", ops._flash_fwd))
    return n


@pytest.mark.parametrize("name", ["yi6b.chat", "mixtral.rag"])
@pytest.mark.parametrize("slots", [4, 128])
def test_reckoned_launches_equal_the_calls(counting, name, slots):
    from repro_torch.models import model as M

    cell = tiny.cell(name)
    cfg = harness.model_config(cell.conf)
    params = weights.draw(cfg, 3, torch.device("cpu"), harness.DTYPES[cell.conf["expert_dtype"]])
    plen = 128
    toks = torch.randint(1, cfg.vocab, (1, plen))
    M.prefill(cfg, params, {"tokens": toks}, cache_len=plen + 8, device="cpu")
    want = K.prefill_launches(cell.conf, plen)
    assert counting == {k: len(v) for k, v in want.items()}
    assert want["photonic_mac"] and want["flash_attention"]

    for k in counting:
        counting[k] = 0
    cache = M.init_cache(cfg, slots, plen + 8, device="cpu")
    M.serve_step(cfg, params, cache, torch.ones((slots, 1), dtype=torch.long),
                 torch.full((slots,), 5), device="cpu")
    want = K.decode_launches(cell.conf, slots)
    assert counting == {k: len(v) for k, v in want.items()}
    assert bool(want["photonic_mac"]) == (slots % 128 == 0)


def test_flops_of_a_token():
    c = tiny.cell("yi6b.chat").conf
    per_layer = 2 * (128 * 128 * 4 + 3 * 128 * 256)
    assert K.decode_flops(c, 9) == 2 * per_layer + 2 * 128 * 512 + 4 * 2 * 64 * 10 * 2
    assert K.prefill_flops(c, 3) == 3 * 2 * per_layer + 4 * 2 * 64 * 6 * 2
    m = tiny.cell("mixtral.rag").conf
    moe = 2 * (128 * 128 * 4 + 128 * 4 + 2 * 3 * 128 * 256)
    assert K.decode_flops(m, 0) == 2 * moe + 2 * 128 * 512 + 4 * 2 * 64 * 2
