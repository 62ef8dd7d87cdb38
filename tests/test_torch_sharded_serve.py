"""Serving under a mesh (`serve/sharded.py`): the sharded prefill and decode
steps at 8 gloo ranks against the JAX package's compiled ones, on the CPU.

Cases (`CASES`), each a prefill of `SEQ` tokens and `STEPS` decode steps
from the reference's initial weights on (pod 2, data 2, model 2): one
reduced config of every family (dense yi-6b, photonic yi-6b on 128-wide
products, zamba2, xlstm-350m, mixtral-8x7b in both dispatch modes,
seamless-m4t-medium with its encoder, qwen2-vl-72b with M-RoPE positions,
gemma3-27b as family "interleaved", 5:1 local:global), plus the cache
layouts a decode meets:

  * the cache LENGTH on `model` (flash-decoding): every reduced config
    whose one KV head does not split 2 ways (yi-6b, mixtral, qwen2-vl),
    mixtral's windowed cache rolling past its 32 positions;
  * the length on (pod, data), batch 1: `gemma3_27b-b1` (its 2 KV heads on
    `model`, its local windows rolling) and `mixtral_8x7b-b1` (the length
    on all three axes, rolling);
  * a rank's query heads straddling a KV group, with a cache length that
    does not split (`yi_6b-straddle`: 6 heads over 3 KV heads, 45
    positions): the cache holds every KV head whole on every rank.

The reference side is `jax.jit(M.prefill | M.serve_step, in_shardings=...)`
exactly as its dry-run's `_lower_cell` builds them (parameters, batch,
cache and token shardings; the cache `device_put` to its sharding before
each step), inside `actx.activation_sharding`, on a mesh of `AxisType.Auto`
axes.  The port's side: `build_sharded_prefill` / `build_sharded_serve_step`
on `trainer.distribute`'s shards.  Checked at `TOL` (`tests/test_torch_model.py`):
the prefill's and each decode step's logits, gathered over the batch
ranks, and the final cache, gathered from the ranks' shards, against the
reference's and against the port's one-device `prefill` and `serve_step`.

One module fixture runs the reference subprocess and the 8 port ranks
together (`test_torch_distributed._run_both`); the test process imports
no jax.
"""

import dataclasses
import json
import textwrap

import numpy as np
import pytest

from repro_torch import configs as C
from test_torch_distributed import _run_both

WORLD = 8
TIMEOUT_S = 600
SEQ, STEPS = 40, 4
TOL = dict(rtol=1e-4, atol=1e-4)
# a yi-6b whose every product tiles at 4 x 32 prefill rows
PHOTONIC_BANKS = dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=256)
# name -> (config, replaced fields, global batch, prompt length)
CASES = {
    "yi_6b": ("yi_6b", {}, 4, SEQ),
    "yi_6b-photonic": ("yi_6b", dict(PHOTONIC_BANKS, use_photonic_mac=True), 4, 32),
    "yi_6b-straddle": ("yi_6b", dict(n_heads=6, n_kv_heads=3), 4, SEQ + 1),
    "zamba2_1p2b": ("zamba2_1p2b", {}, 4, SEQ),
    "xlstm_350m": ("xlstm_350m", {}, 4, SEQ),
    "mixtral_8x7b": ("mixtral_8x7b", {}, 4, SEQ),
    "mixtral_8x7b-index": ("mixtral_8x7b", dict(moe_dispatch="index"), 4, SEQ),
    "mixtral_8x7b-b1": ("mixtral_8x7b", {}, 1, SEQ),
    "seamless_m4t_medium": ("seamless_m4t_medium", {}, 4, SEQ),
    "qwen2_vl_72b": ("qwen2_vl_72b", {}, 4, SEQ),
    "gemma3_27b": ("gemma3_27b", dict(family="interleaved"), 4, SEQ),
    "gemma3_27b-b1": ("gemma3_27b", dict(family="interleaved"), 1, SEQ),
}
FRAMES = 10          # seamless's encoder frames


def case_cfg(case: str):
    arch, repl, _, _ = CASES[case]
    return dataclasses.replace(C.get_reduced(arch), **repl)


def case_inputs(case: str, rng) -> dict:
    """The prompt (and positions, encoder frames) and the decode tokens."""
    cfg = case_cfg(case)
    _, _, b, s = CASES[case]
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "steps": rng.integers(0, cfg.vocab, (STEPS, b, 1)).astype(np.int32)}
    if cfg.mrope:   # distinct streams: t the index, h and w a small grid
        t = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
        out["positions"] = np.stack([t, t // 4, t % 4]).astype(np.int32)
    if cfg.encoder_layers:
        out["enc_embeds"] = rng.standard_normal((b, FRAMES, cfg.d_model)).astype(np.float32)
    return out


REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec
    from repro import configs as C
    from repro.models import model as M
    from repro.parallel import actx
    from repro.parallel import sharding as S

    tmp = sys.argv[1]
    setup = json.loads(open(f"{tmp}/setup.json").read())
    inp = dict(np.load(f"{tmp}/inputs.npz"))
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
    keystr = jax.tree_util.keystr
    cfgs = {case: dataclasses.replace(C.get_reduced(arch), **repl)
            for case, (arch, repl, _, _) in setup["cases"].items()}
    inits = {case: M.init(cfg, jax.random.PRNGKey(0)) for case, cfg in cfgs.items()}
    np.savez(f"{tmp}/init.tmp.npz", **{f"{case}|{keystr(k)}": np.asarray(v)
                                        for case, (p, _) in inits.items()
                                        for k, v in jax.tree_util.tree_leaves_with_path(p)})
    os.replace(f"{tmp}/init.tmp.npz", f"{tmp}/ref_init.npz")
    arrays = {}
    for case, (arch, repl, b, s) in setup["cases"].items():
        cfg = cfgs[case]
        params, pspecs = inits[case]
        get = lambda name: jnp.asarray(inp[f"{case}|{name}"])
        rules = S.rules_for(cfg, mesh)
        params_shape = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)
        param_sh = S.enforce_divisibility(S.tree_shardings(mesh, pspecs, rules), params_shape)
        batch = {"tokens": get("tokens")}
        if cfg.mrope:
            batch["positions"] = get("positions")
        if cfg.encoder_layers:
            batch["enc_embeds"] = get("enc_embeds")
        batch_sh = S.train_batch_shardings(cfg, mesh, batch)
        cache_len = s + setup["steps"]
        cache_shape, cache_specs = M.init_cache_abstract(cfg, b, cache_len)
        cache_sh = S.enforce_divisibility(
            S.cache_shardings(cfg, mesh, cache_specs, b, rules), cache_shape)
        tok_sh = S.train_batch_shardings(cfg, mesh, {"t": get("steps")[0]})["t"]
        ps = NamedSharding(mesh, PartitionSpec())
        dp = S.batch_axes(mesh, b)
        with mesh, actx.activation_sharding(mesh, dp):
            pf = jax.jit(lambda p, bt: M.prefill(cfg, p, bt, cache_len=cache_len),
                         in_shardings=(param_sh, batch_sh))
            p_in = jax.device_put(params, param_sh)
            logits, cache = pf(p_in, jax.device_put(batch, batch_sh))
            arrays[f"logits|{case}|0"] = np.asarray(logits)
            if cfg.encoder_layers:
                enc = jax.jit(lambda p, e: M.encode(cfg, p, e))(params, batch["enc_embeds"])
                enc_sh = S.train_batch_shardings(cfg, mesh, {"e": enc})["e"]
                sv = jax.jit(lambda p, c, t, pos, e: M.serve_step(cfg, p, c, t, pos, enc_out=e),
                             in_shardings=(param_sh, cache_sh, tok_sh, ps, enc_sh))
                extra = (jax.device_put(enc, enc_sh),)
            else:
                sv = jax.jit(lambda p, c, t, pos: M.serve_step(cfg, p, c, t, pos),
                             in_shardings=(param_sh, cache_sh, tok_sh, ps))
                extra = ()
            for i in range(setup["steps"]):
                logits, cache = sv(p_in, jax.device_put(cache, cache_sh),
                                   jax.device_put(get("steps")[i], tok_sh),
                                   jax.device_put(jnp.int32(s + i), ps), *extra)
                arrays[f"logits|{case}|{i + 1}"] = np.asarray(logits)
        for k, v in jax.tree_util.tree_leaves_with_path(cache):
            arrays[f"cache|{case}|{keystr(k)}"] = np.asarray(v)
    np.savez(f"{tmp}/ref.npz", **arrays)
""")

RANK_SCRIPT = textwrap.dedent("""
    import json, os, sys, time
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, tmp, tests = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    sys.path.insert(0, tests)
    from test_torch_sharded_serve import CASES, STEPS, case_cfg
    from repro_torch import tree as T
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as S
    from repro_torch.runtime import trainer as TR
    from repro_torch.serve import sharded as SV

    mesh = make_test_mesh(data=2, model=2, pod=2, device_type="cpu")
    deadline = time.time() + 540
    while not os.path.exists(f"{tmp}/ref_init.npz"):      # the reference's weights
        assert time.time() < deadline, "the reference wrote no initial weights"
        time.sleep(0.2)
    ref = np.load(f"{tmp}/ref_init.npz")
    inp = np.load(f"{tmp}/inputs.npz")
    out = {}

    def whole(local, sh, shape):
        # a rank's shard of a tensor laid out as `sh`, gathered whole
        return TR.gather(TR._as_dtensor(mesh, local.contiguous(), sh.spec, shape))

    for case, (arch, _, b, s) in CASES.items():
        cfg = case_cfg(case)
        like, _ = M.init_abstract(cfg)
        params = T.unflatten(like, [torch.from_numpy(ref[f"{case}|{n}"])
                                    for n, _ in T.leaves_with_path(like)])
        get = lambda name: torch.from_numpy(inp[f"{case}|{name}"])
        batch = {"tokens": get("tokens")}
        if cfg.mrope:
            batch["positions"] = get("positions")
        if cfg.encoder_layers:
            batch["enc_embeds"] = get("enc_embeds")
        cache_len = s + STEPS
        prefill, psh, _, csh = SV.build_sharded_prefill(cfg, mesh, None, batch, cache_len,
                                                         device="cpu")
        abstract, _ = M.init_cache_abstract(cfg, b, cache_len)
        step, _, _, tok_sh = SV.build_sharded_serve_step(cfg, mesh, None, abstract,
                                                         device="cpu")
        shards = TR.distribute(mesh, params, psh)
        enc = M.encode(cfg, params, batch["enc_embeds"], device="cpu") if cfg.encoder_layers else None
        logits, cache = prefill(shards, batch)
        got = [logits]
        for i in range(STEPS):
            logits, cache = step(shards, cache, get("steps")[i], s + i, enc_out=enc)
            got.append(logits)
        for i, lg in enumerate(got):
            out[f"logits|{case}|{i}"] = whole(lg, tok_sh, (b,) + tuple(lg.shape[1:]))
        for (n, t), sh, full in zip(T.leaves_with_path(cache), T.leaves(csh),
                                    T.leaves(abstract)):
            out[f"cache|{case}|{n}"] = whole(t, sh, tuple(full.shape))
        if rank == 0:       # the one-device steps
            lg, c1 = M.prefill(cfg, params, batch, cache_len, device="cpu")
            out[f"one|{case}|0"] = lg
            for i in range(STEPS):
                lg, c1 = M.serve_step(cfg, params, c1, get("steps")[i], s + i, enc_out=enc,
                                      device="cpu")
                out[f"one|{case}|{i + 1}"] = lg
            for n, t in T.leaves_with_path(c1):
                out[f"one_cache|{case}|{n}"] = t
        out[f"spec|{case}"] = np.array(json.dumps([repr(sh.spec) for sh in T.leaves(csh)]))
    if rank == 0:
        np.savez(f"{tmp}/port.npz", **{k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                                       for k, v in out.items()})
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_sharded_serve")
    rng = np.random.default_rng(0)
    inputs = {}
    for case in CASES:
        for k, v in case_inputs(case, rng).items():
            inputs[f"{case}|{k}"] = v
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "setup.json").write_text(json.dumps({"cases": CASES, "steps": STEPS}))
    _run_both(tmp, REF_SCRIPT, RANK_SCRIPT, TIMEOUT_S)
    return {"ref": dict(np.load(tmp / "ref.npz")), "port": dict(np.load(tmp / "port.npz"))}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_logits_match_reference(runs, case):
    """The prefill's and every decode step's logits (gathered over the
    batch ranks) against the reference's compiled sharded steps and the
    port's one-device steps."""
    ref, port = runs["ref"], runs["port"]
    for i in range(STEPS + 1):
        got = port[f"logits|{case}|{i}"]
        np.testing.assert_allclose(got, ref[f"logits|{case}|{i}"], **TOL,
                                   err_msg=f"{case} step {i} against the reference")
        np.testing.assert_allclose(got, port[f"one|{case}|{i}"], **TOL,
                                   err_msg=f"{case} step {i} against one device")


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_cache_matches_reference(runs, case):
    """The cache after the last decode step, gathered from the ranks'
    shards, against the reference's and the one-device cache, leaf by leaf."""
    ref, port = runs["ref"], runs["port"]
    keys = [k for k in port if k.startswith(f"cache|{case}|")]
    assert keys and len(keys) == len([k for k in ref if k.startswith(f"cache|{case}|")])
    for k in keys:
        np.testing.assert_allclose(port[k], ref[k].astype(np.float32), **TOL, err_msg=k)
        one = k.replace("cache|", "one_cache|", 1)
        np.testing.assert_allclose(port[k], port[one], **TOL, err_msg=one)


def test_cache_layouts_cover_every_split(runs):
    """The cases meet each layout the decode supports: the length on
    `model`, on (pod, data) with the KV heads on `model`, on all three
    axes, and a length that stays whole beside every KV head."""
    specs = {case: json.loads(str(runs["port"][f"spec|{case}"])) for case in CASES}
    k_spec = {case: s[0] for case, s in specs.items()}   # the first block's K, layers first
    assert k_spec["yi_6b"] == "P(None, ('pod', 'data'), None, 'model', None)"
    assert k_spec["gemma3_27b-b1"] == "P(None, None, 'model', ('pod', 'data'), None)"
    assert k_spec["mixtral_8x7b-b1"] == "P(None, None, None, ('pod', 'data', 'model'), None)"
    assert k_spec["yi_6b-straddle"] == "P(None, ('pod', 'data'), None, None, None)"
