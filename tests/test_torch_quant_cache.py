"""The banked levels kept per weight change (`kernels.ops._LEVELS`), on the
CPU at small shapes: a hit gives the bits a fresh quantise gives, every
write through any alias of the weight makes the next call a miss, no two
views, bit widths or slices share an entry, an entry dies with its weight,
and training, the per-column path, a split's MAX, an inference tensor and
a dispatch mode never engage the cache."""

import dataclasses
import gc
import weakref

import pytest
import torch
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as C
from repro_torch.kernels import ops
from repro_torch.kernels.photonic_mac import quantize_weights
from repro_torch.models import model as M

L, K, N, ROWS = 3, 256, 384, 128


def _counts():
    return ops.photonic_matmul.quant_hits, ops.photonic_matmul.quant_misses


def _moved(before):
    h, m = _counts()
    return h - before[0], m - before[1]


def _kept(root):
    """The entries kept for `root`: {key: (version, w_q, scale)}."""
    return ops._LEVELS.get(root, {})


def _view(stack, i):
    """Layer i of a layer-stacked weight as `linear` hands it on: a fresh
    view each call."""
    return stack[i].reshape(K, -1)


def _cold(x, w, bits=8, shard=None):
    """The product on a copy of w: a new root, so its levels are built."""
    with torch.no_grad():
        return ops.photonic_matmul(x, w.clone(), bits, False, shard)


@pytest.fixture
def stack():
    gen = torch.Generator().manual_seed(3)
    return torch.randn(L, K, N, generator=gen)


@pytest.fixture
def x():
    return torch.randn(ROWS, K, generator=torch.Generator().manual_seed(4))


def test_repeated_calls_on_fresh_views_hit_and_give_the_cold_bits(stack, x):
    outs = []
    with torch.no_grad():
        for rep in range(3):
            for i in range(L):
                before = _counts()
                outs.append((i, ops.photonic_matmul(x, _view(stack, i), 8, False)))
                assert _moved(before) == ((0, 1) if rep == 0 else (1, 0))
    for i, out in outs:
        assert torch.equal(out, _cold(x, _view(stack, i)))
    kept = _kept(stack)
    assert len(kept) == L
    for (off, shape, *_), (version, w_q, scale) in kept.items():
        want_q, want_s = quantize_weights(stack.flatten()[off:off + K * N].view(K, N))
        assert version == stack._version and shape == (K, N)
        assert torch.equal(w_q, want_q) and torch.equal(scale, want_s)


WRITES = {
    "root": lambda stack, i: stack.add_(0.25),
    "view": lambda stack, i: _view(stack, i).mul_(-2.0),
    "copy": lambda stack, i: stack[i].copy_(torch.linspace(-3, 3, K * N).view(K, N)),
}


@pytest.mark.parametrize("how", sorted(WRITES))
def test_a_write_through_any_alias_makes_the_next_call_miss(stack, x, how):
    with torch.no_grad():
        ops.photonic_matmul(x, _view(stack, 1), 8, False)
        WRITES[how](stack, 1)
        before = _counts()
        out = ops.photonic_matmul(x, _view(stack, 1), 8, False)
        assert _moved(before) == (0, 1)
        again = ops.photonic_matmul(x, _view(stack, 1), 8, False)
        assert _moved(before) == (1, 1)
    assert torch.equal(out, _cold(x, _view(stack, 1))) and torch.equal(again, out)
    # the stale entry was replaced, not kept beside the new one
    (version, w_q, _), = _kept(stack).values()
    assert version == stack._version
    assert torch.equal(w_q, quantize_weights(stack[1].clone())[0])


SHARDS = {
    "cols": [ops.Shard(m=ROWS, split="cols", index=i, parts=2) for i in range(2)],
    "rows": [ops.Shard(m=ROWS, split="rows", index=i, parts=2) for i in range(2)],
}


def test_layers_bits_and_slices_never_share_an_entry(stack, x):
    w = stack[0][:, :192]                                   # a column slice: 1.5 banks
    xr = x[:, :192]
    cases = [(x, _view(stack, 0), 8, None), (x, _view(stack, 1), 8, None),
             (x, _view(stack, 0), 4, None)]
    cases += [(x, w, 8, s) for s in SHARDS["cols"]]
    cases += [(xr, stack[0][:192], 8, s) for s in SHARDS["rows"]]
    with torch.no_grad():
        for rep in range(2):
            for xi, wi, bits, shard in cases:
                before = _counts()
                out = ops.photonic_matmul(xi, wi, bits, False, shard)
                assert _moved(before) == ((0, 1) if rep == 0 else (1, 0))
                assert torch.equal(out, _cold(xi, wi, bits, shard))
    assert len(_kept(stack)) == len(cases)


# a slice that straddles a bank (1.5 banks of 2 x 1.5 globally): the miss
# pads the weight to quantise it, a hit pads only what the product needs
STRADDLE = {"cols": lambda stack, x: (x, stack[0][:, :192], SHARDS["cols"][1], []),
            "rows": lambda stack, x: (x[:, :192], stack[0][:192], SHARDS["rows"][1],
                                      [(ROWS, 192)])}


@pytest.mark.parametrize("split", sorted(STRADDLE))
def test_a_hit_pads_no_weight(stack, x, split, monkeypatch):
    xi, wi, shard, x_pads = STRADDLE[split](stack, x)
    pad, padded = torch.nn.functional.pad, []

    def counted(t, *args, **kwargs):
        padded.append(tuple(t.shape))
        return pad(t, *args, **kwargs)
    with torch.no_grad():
        cold = ops.photonic_matmul(xi, wi, 8, False, shard)
        monkeypatch.setattr(torch.nn.functional, "pad", counted)
        before = _counts()
        out = ops.photonic_matmul(xi, wi, 8, False, shard)
    assert _moved(before) == (1, 0)
    assert padded == x_pads              # x's columns for a row slice, never w
    assert torch.equal(out, cold)


def _never(stack, x, call):
    before = _counts()
    call()
    call()
    assert _moved(before) == (0, 0)
    assert not _kept(stack)


def test_training_never_engages_and_its_backward_is_straight_through(stack, x):
    stack.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    g = torch.randn(ROWS, N, generator=torch.Generator().manual_seed(5))
    _never(stack, x, lambda: ops.photonic_matmul(xg, _view(stack, 1), 8, False).backward(g))
    assert torch.equal(xg.grad, 2 * (g @ stack[1].detach().t()))
    assert torch.equal(stack.grad[1], 2 * (x.t() @ g))
    assert not stack.grad[0].any() and not stack.grad[2].any()


NEVER = {
    "per_column": lambda stack, x: ops.photonic_matmul(x[:5], _view(stack, 0), 8, False),
    "split_max": lambda stack, x: ops.photonic_matmul(
        x, stack[0][:, :192], 8, False,
        dataclasses.replace(SHARDS["cols"][1], reduce_max=lambda t: t)),
    "dispatch_mode": lambda stack, x: _under(FlopCounterMode(display=False), ops.photonic_matmul,
                                             x, _view(stack, 0), 8, False),
}


def _under(mode, fn, *args):
    with mode:
        return fn(*args)


@pytest.mark.parametrize("case", sorted(NEVER))
def test_what_never_engages(stack, x, case):
    with torch.no_grad():
        _never(stack, x, lambda: NEVER[case](stack, x))


def test_an_inference_tensor_never_engages(stack, x):
    with torch.inference_mode():
        inf = stack.clone()
        _never(inf, x, lambda: ops.photonic_matmul(x, _view(inf, 0), 8, False))


def test_an_entry_dies_with_its_weight(x):
    w = torch.randn(K, N)
    with torch.no_grad():
        ops.photonic_matmul(x, w.reshape(K, -1), 8, False)
    (_, w_q, scale), = _kept(w).values()
    alive = [weakref.ref(w_q), weakref.ref(scale)]
    del w, w_q, scale
    gc.collect()
    assert all(r() is None for r in alive)


WIDTHS = dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256,
              vocab=512)


def _serve(cfg, params, tokens, steps=3):
    logits, cache = M.prefill(cfg, params, {"tokens": tokens}, cache_len=16, device="cpu")
    out = [logits]
    for j in range(steps):
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        logits, cache = M.serve_step(cfg, params, cache, tok, tokens.shape[1] + j,
                                     device="cpu")
        out.append(logits)
    return out


def test_a_warm_cache_serves_the_bits_of_fresh_parameters():
    """prefill (128 x 8 rows) and decode steps (128 slots) of a dense
    photonic model: every product banked."""
    torch.manual_seed(0)
    cfg = dataclasses.replace(C.get("yi_6b"), **WIDTHS, use_photonic_mac=True,
                              use_kernels=True)
    params = M.init(cfg, seed=0, device="cpu")
    tokens = torch.randint(2, cfg.vocab, (128, 8), generator=torch.Generator().manual_seed(6))
    before = _counts()
    _serve(cfg, params, tokens)
    cold = _moved(before)               # the prefill builds each weight's levels
    assert cold[1] == 2 * 7 + 1         # two layers' seven products and the head
    before = _counts()
    warm = _serve(cfg, params, tokens)
    assert _moved(before) == (sum(cold), 0)
    before = _counts()
    fresh = _serve(cfg, tree_map(torch.clone, params), tokens)
    assert _moved(before) == cold
    assert all(torch.equal(a, b) for a, b in zip(warm, fresh))
