"""The port's continuous-batching engine against the JAX engine, on the CPU:
ragged requests through shared cache slots must produce the same greedy
token ids as the JAX `ContinuousBatcher` on the same weights and prompts, and
the same as the port's own independent per-request decode.  Token ids are
compared exactly; logits to 1e-5 (same f32 arithmetic, other summation
order)."""

import jax
import jax.experimental
import numpy as np
import pytest
import torch

# `repro.serve.engine` imports `repro.core`, whose power model imports
# `jax.experimental.enable_x64`; newer jax only has `jax.enable_x64`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import ContinuousBatcher as JContinuousBatcher  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serve.engine import ContinuousBatcher, _slot_update  # noqa: E402

LENGTHS = [5, 9, 3, 7]
MAX_NEWS = [6, 4, 5, 3]
MAX_LEN = 64


def _setup(seed=0, arch="yi_6b"):
    jcfg, cfg = JC.get_reduced(arch), C.get_reduced(arch)
    jparams, _ = JM.init(jcfg, jax.random.PRNGKey(seed))
    params = params_from_reference(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab, n)] for n in LENGTHS]
    return jcfg, jparams, cfg, params, prompts


def _independent_decode(cfg, params, prompt, max_new, max_len):
    if len(prompt) > 1:
        _, cache = M.prefill(cfg, params, {"tokens": np.asarray([prompt[:-1]])},
                             cache_len=max_len, device="cpu")
    else:
        cache = M.init_cache(cfg, 1, max_len, device="cpu")
    out, tok, pos = [], prompt[-1], len(prompt) - 1
    for _ in range(max_new):
        logits, cache = M.serve_step(cfg, params, cache, np.asarray([[tok]]), pos,
                                     device="cpu")
        tok = int(torch.argmax(logits[0, -1]))
        out.append(tok)
        pos += 1
    return out


@pytest.mark.parametrize("bucket", [16, 8])
def test_continuous_batching_matches_the_reference_engine(bucket):
    jcfg, jparams, cfg, params, prompts = _setup()
    jeng = JContinuousBatcher(jcfg, jparams, n_slots=2, max_len=MAX_LEN, prompt_bucket=bucket)
    jreqs = [jeng.submit(p, mn) for p, mn in zip(prompts, MAX_NEWS)]
    jeng.run()

    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=MAX_LEN, prompt_bucket=bucket,
                            device="cpu")
    reqs = [eng.submit(p, mn) for p, mn in zip(prompts, MAX_NEWS)]
    finished = eng.run()
    assert len(finished) == len(reqs) and all(r.done for r in reqs)
    assert eng.stats["decode_iters"] == jeng.net_stats["decode_iters"]
    for r, jr, mn in zip(reqs, jreqs, MAX_NEWS):
        assert len(r.out) == mn
        assert r.out == jr.out, (r.prompt, r.out, jr.out)


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_350m"])
def test_recurrent_families_match_the_reference_engine(arch):
    """Exact-length prefill (the recurrent state integrates every input token)
    and slot churn through mamba / shared-attention / mLSTM / sLSTM caches,
    against the JAX engine and against independent per-request decode."""
    jcfg, jparams, cfg, params, prompts = _setup(arch=arch)
    jeng = JContinuousBatcher(jcfg, jparams, n_slots=2, max_len=MAX_LEN)
    jreqs = [jeng.submit(p, mn) for p, mn in zip(prompts, MAX_NEWS)]
    jeng.run()
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=MAX_LEN, device="cpu")
    assert eng.bucket == 1
    reqs = [eng.submit(p, mn) for p, mn in zip(prompts, MAX_NEWS)]
    eng.run()
    assert eng.stats["prefill_tokens"] == sum(n - 1 for n in LENGTHS)
    for p, r, jr, mn in zip(prompts, reqs, jreqs, MAX_NEWS):
        assert r.done and len(r.out) == mn
        assert r.out == jr.out, (p, r.out, jr.out)
        assert r.out == _independent_decode(cfg, params, p, mn, MAX_LEN), p


def test_continuous_batching_matches_independent_decode():
    _, _, cfg, params, prompts = _setup()
    prompts = prompts + [[7]]                  # a one-token prompt: empty prefill
    max_news = MAX_NEWS + [3]
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=MAX_LEN, device="cpu")
    reqs = [eng.submit(p, mn) for p, mn in zip(prompts, max_news)]
    eng.run()
    for p, mn, r in zip(prompts, max_news, reqs):
        assert r.out == _independent_decode(cfg, params, p, mn, MAX_LEN), p


def test_eos_and_length_limits_stop_requests():
    _, _, cfg, params, prompts = _setup()
    probe = ContinuousBatcher(cfg, params, n_slots=1, max_len=MAX_LEN, device="cpu")
    r0 = probe.submit(prompts[0], 6)
    probe.run()
    eng = ContinuousBatcher(cfg, params, n_slots=1, max_len=MAX_LEN, eos_id=r0.out[2],
                            device="cpu")
    r1 = eng.submit(prompts[0], 6)
    eng.run()
    assert r1.out == r0.out[:r0.out.index(r0.out[2]) + 1]
    short = ContinuousBatcher(cfg, params, n_slots=1, max_len=len(prompts[1]) + 2,
                              prompt_bucket=1, device="cpu")
    r2 = short.submit(prompts[1], 10)
    short.run()
    assert r2.done and len(r2.out) == 2          # pos reaches max_len - 1


def test_prompt_that_does_not_fit_the_cache_is_rejected():
    _, _, cfg, params, prompts = _setup()
    eng = ContinuousBatcher(cfg, params, n_slots=1, max_len=16, prompt_bucket=16, device="cpu")
    eng.submit(prompts[1], 2)                      # 8 prompt tokens pad to 16 = max_len
    with pytest.raises(ValueError, match="max_len"):
        eng.run()


def test_vector_position_decode_matches_scalar():
    """serve_step with a (B,) position vector == the scalar call."""
    _, _, cfg, params, _ = _setup()
    b, s, max_len = 3, 12, 32
    rng = np.random.default_rng(2)
    toks = rng.integers(2, cfg.vocab, (b, s))
    nxt = rng.integers(2, cfg.vocab, (b, 1))
    _, cache = M.prefill(cfg, params, {"tokens": toks}, cache_len=max_len, device="cpu")
    lg_scalar, _ = M.serve_step(cfg, params, cache, nxt, s, device="cpu")
    lg_vec, _ = M.serve_step(cfg, params, cache, nxt, np.full((b,), s), device="cpu")
    lg_tensor, _ = M.serve_step(cfg, params, cache, nxt, torch.full((b,), s), device="cpu")
    np.testing.assert_allclose(lg_scalar.numpy(), lg_vec.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lg_scalar.numpy(), lg_tensor.numpy(), rtol=1e-5, atol=1e-5)


def test_ragged_vector_positions_match_the_reference():
    jcfg, jparams, cfg, params, _ = _setup()
    b, s, max_len = 3, 12, 32
    rng = np.random.default_rng(3)
    toks = rng.integers(2, cfg.vocab, (b, s)).astype(np.int32)
    nxt = rng.integers(2, cfg.vocab, (b, 1)).astype(np.int32)
    pos = np.asarray([4, 12, 9], np.int32)
    _, cache = M.prefill(cfg, params, {"tokens": toks}, cache_len=max_len, device="cpu")
    _, jcache = JM.prefill(jcfg, jparams, {"tokens": jax.numpy.asarray(toks)}, cache_len=max_len)
    lg, _ = M.serve_step(cfg, params, cache, nxt, pos, device="cpu")
    jlg, _ = JM.serve_step(jcfg, jparams, jcache, jax.numpy.asarray(nxt), jax.numpy.asarray(pos))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=1e-4, atol=1e-4)


def test_slot_update_writes_one_slot_in_place():
    cfg = C.get_reduced("yi_6b")
    pool = M.init_cache(cfg, 3, 8, device="cpu")
    one = M.init_cache(cfg, 1, 8, device="cpu")
    one[0]["attn_0"]["k"].fill_(2.0)
    same = _slot_update(pool, one, 1, 3)
    assert same is pool
    k = pool[0]["attn_0"]["k"]
    assert bool((k[:, 1] == 2.0).all()) and not k[:, 0].any() and not k[:, 2].any()


def test_slot_update_writes_fused_batch_heads_leaves():
    """mLSTM's (C, n) put batch and heads on one axis: slot i owns rows
    i*H .. (i+1)*H - 1 of it."""
    cfg = C.get_reduced("xlstm_350m")
    h = cfg.n_heads
    pool = M.init_cache(cfg, 3, 8, device="cpu")
    one = M.init_cache(cfg, 1, 8, device="cpu")
    one[0]["mlstm_0"]["C"].fill_(2.0)
    one[0]["slstm_3"]["m"].fill_(5.0)
    _slot_update(pool, one, 2, 3)
    c = pool[0]["mlstm_0"]["C"]
    assert bool((c[:, 2 * h:] == 2.0).all()) and not c[:, :2 * h].any()
    m = pool[0]["slstm_3"]["m"]
    assert bool((m[:, 2] == 5.0).all()) and bool((m[:, :2] == -10.0).all())


def test_fabric_hook_is_not_ported():
    """The fabric hook is ported (`tests/test_torch_fabric.py` holds its
    fault epoch against the reference's); an unknown preset name is refused
    at construction, as the reference's `get_fabric` refuses it."""
    _, _, cfg, params, _ = _setup()
    with pytest.raises(KeyError, match="unknown fabric preset"):
        ContinuousBatcher(cfg, params, n_slots=1, max_len=8, fabric="trine", device="cpu")
    eng = ContinuousBatcher(cfg, params, n_slots=1, max_len=8, fabric="trine_siph", device="cpu")
    assert eng.net_stats["replans"] == 1 and eng.collective_channels >= 1


def test_encoder_decoder_config_is_refused_by_the_batcher():
    """The reference's batcher prefills from tokens alone, so for seamless it
    fails with KeyError('enc_embeds'); the port's refuses the config at
    construction with `ValueError` and adds no encoder batching."""
    jcfg, jparams, cfg, params, prompts = _setup(arch="seamless_m4t_medium")
    jeng = JContinuousBatcher(jcfg, jparams, n_slots=2, max_len=MAX_LEN)
    jeng.submit(prompts[0], 2)
    with pytest.raises(KeyError, match="enc_embeds"):
        jeng.run()
    with pytest.raises(ValueError, match="enc_embeds"):
        ContinuousBatcher(cfg, params, n_slots=2, max_len=MAX_LEN, device="cpu")


def test_launch_serve_main_serves_seamless_on_the_cpu(capsys):
    """The launcher draws S // 4 frames, encodes them once for the decode
    steps, and the prefill encodes them again; the tokens match a prefill
    and decode steps by hand against the same frames."""
    from repro_torch.launch import serve
    res = serve.main(["--arch", "seamless-m4t-medium", "--reduced", "--batch", "2",
                      "--prompt-len", "16", "--max-new", "4", "--device", "cpu",
                      "--photonic", "--kernels"])
    assert tuple(res["tokens"].shape) == (2, 4)
    assert int(res["tokens"].min()) >= 0 and int(res["tokens"].max()) < 512
    assert bool(torch.isfinite(res["logits"]).all())
    assert "decode :" in capsys.readouterr().out
    import dataclasses
    cfg = dataclasses.replace(C.get_reduced("seamless_m4t_medium"), use_photonic_mac=True,
                              use_kernels=True)
    params = M.init(cfg, seed=0, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(1)
    prompts = torch.randint(2, cfg.vocab, (2, 16), generator=gen)
    enc = torch.randn((2, 4, cfg.d_model), generator=gen)
    logits, cache = M.prefill(cfg, params, {"tokens": prompts, "enc_embeds": enc},
                              cache_len=20, device="cpu")
    enc_out = M.encode(cfg, params, enc, device="cpu")
    toks = [torch.argmax(logits[:, -1], -1)[:, None]]
    for i in range(3):
        logits, cache = M.serve_step(cfg, params, cache, toks[-1], 16 + i, enc_out=enc_out,
                                     device="cpu")
        toks.append(torch.argmax(logits[:, -1], -1)[:, None])
    assert torch.equal(torch.cat(toks, 1), res["tokens"])


def test_mrope_continuous_batching_matches_the_reference_engine():
    """qwen2-vl through 2 slots at bucket 16: each slot decodes with its own
    (3, B, 1) M-RoPE positions, the index on every stream, as in the JAX
    engine, and as an independent per-request decode does."""
    jcfg, jparams, cfg, params, prompts = _setup(arch="qwen2_vl_72b")
    jeng = JContinuousBatcher(jcfg, jparams, n_slots=2, max_len=MAX_LEN, prompt_bucket=16)
    jreqs = [jeng.submit(p, mn) for p, mn in zip(prompts, MAX_NEWS)]
    jeng.run()
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=MAX_LEN, prompt_bucket=16,
                            device="cpu")
    reqs = [eng.submit(p, mn) for p, mn in zip(prompts, MAX_NEWS)]
    eng.run()
    for p, r, jr, mn in zip(prompts, reqs, jreqs, MAX_NEWS):
        assert r.done and len(r.out) == mn
        assert r.out == jr.out, (p, r.out, jr.out)
        assert r.out == _independent_decode(cfg, params, p, mn, MAX_LEN), p


def test_launch_serve_main_serves_qwen2_vl_on_the_cpu(capsys):
    """The launcher prefills with equal (3, B, S) streams; the tokens match
    a prefill with the default positions and decode steps by hand."""
    import dataclasses
    from repro_torch.launch import serve
    res = serve.main(["--arch", "qwen2-vl-72b", "--reduced", "--batch", "2", "--prompt-len",
                      "16", "--max-new", "4", "--device", "cpu", "--photonic", "--kernels"])
    assert tuple(res["tokens"].shape) == (2, 4)
    assert bool(torch.isfinite(res["logits"]).all())
    assert "decode :" in capsys.readouterr().out
    cfg = dataclasses.replace(C.get_reduced("qwen2_vl_72b"), use_photonic_mac=True,
                              use_kernels=True)
    params = M.init(cfg, seed=0, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(1)
    prompts = torch.randint(2, cfg.vocab, (2, 16), generator=gen)
    logits, cache = M.prefill(cfg, params, {"tokens": prompts}, cache_len=20, device="cpu")
    toks = [torch.argmax(logits[:, -1], -1)[:, None]]
    for i in range(3):
        logits, cache = M.serve_step(cfg, params, cache, toks[-1], 16 + i, device="cpu")
        toks.append(torch.argmax(logits[:, -1], -1)[:, None])
    assert torch.equal(torch.cat(toks, 1), res["tokens"])


def test_launch_serve_main_runs_on_the_cpu_on_request(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--arch", "yi-6b", "--reduced", "--batch", "2", "--prompt-len", "16",
                      "--max-new", "4", "--device", "cpu", "--photonic", "--kernels"])
    assert tuple(res["tokens"].shape) == (2, 4)
    assert int(res["tokens"].min()) >= 0
    assert bool(torch.isfinite(res["logits"]).all())
    assert "prefill:" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_launch_serve_main_serves_the_recurrent_families_on_the_cpu(capsys, arch):
    from repro_torch.launch import serve
    res = serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "16",
                      "--max-new", "4", "--device", "cpu", "--photonic", "--kernels"])
    assert tuple(res["tokens"].shape) == (2, 4)
    assert int(res["tokens"].min()) >= 0 and int(res["tokens"].max()) < 512
    assert bool(torch.isfinite(res["logits"]).all())
    assert "decode :" in capsys.readouterr().out


def test_moe_continuous_batching_matches_the_reference_engine():
    """mixtral through 2 slots at bucket 16, against the JAX engine.  Right
    padding takes expert capacity (pad positions' first choices come before
    the real tokens' second choices), so a request's numbers depend on its
    bucket; the port reproduces the reference's engine, padding included.
    The padded prefill of the first prompt changes the K/V of its real
    positions in the second layer against an exact-length prefill, so this
    run does exercise that."""
    jcfg, jparams, cfg, params, prompts = _setup(arch="mixtral_8x7b")
    jeng = JContinuousBatcher(jcfg, jparams, n_slots=2, max_len=MAX_LEN, prompt_bucket=16)
    jreqs = [jeng.submit(p, mn) for p, mn in zip(prompts, MAX_NEWS)]
    jeng.run()
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=MAX_LEN, prompt_bucket=16,
                            device="cpu")
    reqs = [eng.submit(p, mn) for p, mn in zip(prompts, MAX_NEWS)]
    eng.run()
    assert eng.bucket == 16 and eng.stats["prefill_tokens"] == 16 * len(prompts)
    for p, r, jr, mn in zip(prompts, reqs, jreqs, MAX_NEWS):
        assert r.done and len(r.out) == mn
        assert r.out == jr.out, (p, r.out, jr.out)

    core = prompts[0][:-1]
    padded = np.zeros((1, 16), np.int64)
    padded[0, :len(core)] = core
    _, c_pad = M.prefill(cfg, params, {"tokens": padded}, cache_len=MAX_LEN, device="cpu")
    _, c_exact = M.prefill(cfg, params, {"tokens": np.asarray([core])}, cache_len=MAX_LEN,
                           device="cpu")
    k_pad, k_exact = c_pad[0]["moe_0"]["k"], c_exact[0]["moe_0"]["k"]
    n = len(core)
    assert torch.allclose(k_pad[0, :, :, :n], k_exact[0, :, :, :n], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(k_pad[1, :, :, :n], k_exact[1, :, :, :n], rtol=1e-3, atol=1e-3)


def test_launch_serve_main_serves_mixtral_on_the_cpu(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--arch", "mixtral-8x7b", "--reduced", "--batch", "2", "--prompt-len",
                      "16", "--max-new", "4", "--device", "cpu", "--photonic", "--kernels"])
    assert tuple(res["tokens"].shape) == (2, 4)
    assert int(res["tokens"].min()) >= 0 and int(res["tokens"].max()) < 512
    assert bool(torch.isfinite(res["logits"]).all())
    assert "decode :" in capsys.readouterr().out


def test_launch_serve_main_takes_params_with_their_config():
    """Weights built for a depth-cut config serve with that config, and
    raise `ValueError` naming both layer counts with the `--arch` config."""
    import dataclasses
    from repro_torch.launch import serve
    cfg = dataclasses.replace(C.get_reduced("mixtral_8x7b"), n_layers=3)
    params = M.init(cfg, seed=0, device="cpu")
    argv = ["--arch", "mixtral-8x7b", "--reduced", "--batch", "2", "--prompt-len", "16",
            "--max-new", "2", "--device", "cpu"]
    res = serve.main(argv, params=params, cfg=cfg)
    assert tuple(res["tokens"].shape) == (2, 2)
    with pytest.raises(ValueError, match=r"\[2\] layers, the parameters \[3\]"):
        serve.main(argv, params=params)


@pytest.mark.parametrize("entry", ["prefill", "serve_step", "forward_hidden", "batcher"])
def test_every_entry_point_refuses_params_of_another_layout(entry):
    """Weights of a 3-layer mixtral run with the 2-layer config raise the same
    `ValueError` from every entry point that runs the layers."""
    import dataclasses
    cfg = C.get_reduced("mixtral_8x7b")
    params = M.init(dataclasses.replace(cfg, n_layers=3), seed=0, device="cpu")
    toks = np.full((1, 8), 3, np.int64)
    with pytest.raises(ValueError, match=r"\[2\] layers, the parameters \[3\]"):
        if entry == "prefill":
            M.prefill(cfg, params, {"tokens": toks}, device="cpu")
        elif entry == "serve_step":
            cache = M.init_cache(cfg, 1, 16, device="cpu")
            M.serve_step(cfg, params, cache, toks[:, :1], 0, device="cpu")
        elif entry == "forward_hidden":
            M.forward_hidden(cfg, params, {"tokens": toks}, device="cpu")
        else:
            eng = ContinuousBatcher(cfg, params, n_slots=1, max_len=32, device="cpu")
            eng.submit(toks[0].tolist(), 2)
            eng.run()
