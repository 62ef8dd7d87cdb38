"""Unified LM of the PyTorch port.

An architecture is a sequence of *stages*; each stage is `(repeat, kinds)`:
`kinds` is a tuple of block kinds executed in order, and the stage is run
`repeat` times with per-kind parameters stacked along a leading "layers" axis
(the reference's layout, kept so that weights cross between the packages as
they are; the reference scans that axis, this port loops over it).

Block kinds:
  attn         dense attention (+MLP); window per cfg.attn_pattern
  local/global gemma3 5:1 interleave (sliding window vs full)
  moe          attention (window per cfg.attn_pattern) + routed experts,
               no MLP; its auxiliary loss is summed over the layers
  mamba        Mamba2 selective-SSM block (zamba2)
  shared_attn  zamba2's weight-shared attention block (one parameter set at
               params["shared_attn"], used by every such block; window
               cfg.window)
  mlstm/slstm  xLSTM blocks
  enc / dec    encoder (bidirectional attention + MLP) / decoder (causal
               self-attention with a cache, cross-attention to the
               encoder's output, MLP); seamless

Entry points: `init`, `loss_fn` (training), `train_logits`, `prefill` +
`serve_step` (inference), `encode` (enc-dec).  `init_abstract` and
`init_cache_abstract` give the trees on the "meta" device with their
logical-axis spec trees, the sharding rules' input (`parallel.sharding`).
Each takes `device`, which defaults to "cuda" and raises without a card; the
CPU is used only on request.  The serving cache is updated in place.

`cfg.remat` (recompute in the backward, `torch.utils.checkpoint`) applies
only while a backward can follow: grad enabled and weights that require it.
Then each repeat of a stage (the reference's scan body: the stage's group
of kinds), each encoder layer and the head of each cross-entropy chunk runs
under its own checkpoint.  "none" saves everything; "full", "dots" and
"dots_all" all recompute in full (the reference's "dots" policies save the
products' outputs; the numbers are the same either way).

Layer-stacked weights may arrive as int8 wire pairs (`parallel.wire`, the
trainer's `param_wire`); each layer body dequantizes its own slice at entry
(`wire.dequant_subtree`).  Whether a stack holds pairs is looked up once
per stage and forward, so a tree without pairs costs no walk per layer.

Under a sharded train step the parameters are a rank's shards, and the
step's gather (`param_gather`) makes each weight whole where it is used:
a layer's slice of every stack at the entry of its body (inside the
checkpoint, so that the recomputation gathers again and a layer's full
weights live only while it runs), and `embed`, `lm_head`, `final_norm`,
`shared_attn` and the encoder's norm where they are used, once per
forward (a weight used twice, zamba2's shared block or a tied embedding,
sums its whole gradient before the gather's backward reduces it).
Without the hook (serving, the one-device step, the wire) nothing
changes.

A sharded serving step (`serve.sharded`) runs `prefill` and `serve_step`
on a rank's slices under the same gather and split, and under
`cache_layout`: `init_cache` makes the rank's shards of the cache, each
attention block reads and writes its K/V as the layout splits them
(`layers.apply_attention(cache_spec=)`), and a recurrent block whose state
the layout splits on a dimension other than the batch computes on it made
whole (`_WholeState`).  Without the context nothing changes.

Under the step's tensor-parallel split (`parallel.actx`) the gather keeps
the `model` slice of the leaves `tp_split_specs` names, and the blocks
(`models.layers`), the embedding and the head compute on their slices: a
vocabulary-split table looks its tokens up where they lie and sums over
the split (one rank's row is nonzero), and a vocabulary-split head leaves
the logits split, so the chunked cross-entropy takes its max, its sum of
exponentials and the gold logit over the split (three small sums a chunk).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import require_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import actx
from repro_torch.parallel import wire as W
from repro_torch.spans import span

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# stage layout
# ---------------------------------------------------------------------------


def stages(cfg: ModelConfig) -> List[Tuple[int, Tuple[str, ...]]]:
    nl = cfg.n_layers
    if cfg.family in ("dense", "vlm"):
        return [(nl, ("attn",))]
    if cfg.family == "moe":
        return [(nl, ("moe",))]
    if cfg.attn_pattern == "local_global" and cfg.local_global_ratio:
        r = cfg.local_global_ratio
        group = ("local",) * r + ("global",)
        full, rem = divmod(nl, r + 1)
        out = [(full, group)]
        if rem:
            out.append((1, ("local",) * rem))
        return out
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        e = cfg.hybrid_attn_every
        group = ("mamba",) * (e - 1) + ("shared_attn",)
        full, rem = divmod(nl, e)
        out = [(full, group)]
        if rem:
            out.append((1, ("mamba",) * rem))
        return out
    if cfg.family == "ssm" and cfg.slstm_ratio:
        r = cfg.slstm_ratio
        group = ("mlstm",) * (r - 1) + ("slstm",)
        full, rem = divmod(nl, r)
        out = [(full, group)]
        if rem:
            out.append((1, ("mlstm",) * rem))
        return out
    if cfg.family == "audio":
        return [(nl, ("dec",))]
    raise ValueError(f"cannot derive stages for {cfg.name}")


# the kinds that hold an attention block and keep a K/V cache
_ATTN_KINDS = ("attn", "local", "global", "shared_attn", "moe", "enc", "dec")


def _kind_window(cfg: ModelConfig, kind: str) -> int:
    if kind == "local":
        return cfg.window
    if kind == "global":
        return 0
    if kind in ("attn", "moe"):
        return cfg.window if cfg.attn_pattern == "sliding" else 0
    if kind == "shared_attn":
        return cfg.window
    return 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


# `keep(axes, leaf)`: what `init` stores of a leaf it has just drawn, given
# the leaf's logical axes (`param_specs`)
InitKeep = Optional[Callable[[Tuple, torch.Tensor], torch.Tensor]]


def _keep_group(keep: InitKeep, specs: Dict[str, Tuple]) -> L.Keep:
    """`keep` for the leaves of one parameter group, named as `specs` names
    their axes."""
    if keep is None:
        return None
    return lambda name, t: keep(specs[name], t)


def _init_blocks(cfg: ModelConfig, kind: str, gen: torch.Generator, device,
                 repeat: int, expert_dtype: Optional[torch.dtype] = None,
                 keep: InitKeep = None) -> Params:
    """`repeat` blocks of one kind, leaves stacked on a leading layer axis."""
    kw = {"device": device, "layers": repeat}
    specs = _stacked_specs(cfg, kind)

    def group(name, init_fn, **extra):
        return init_fn(cfg, gen, keep=_keep_group(keep, specs[name]), **kw, **extra)

    if kind in ("attn", "local", "global", "enc"):
        p = {"attn": group("attn", L.init_attention)}
        if cfg.d_ff:
            p["mlp"] = group("mlp", L.init_mlp)
        return p
    if kind == "moe":
        return {"attn": group("attn", L.init_attention),
                "moe": group("moe", L.init_moe, expert_dtype=expert_dtype)}
    if kind == "shared_attn":
        return {}  # the parameters live once, at params["shared_attn"]
    if kind == "mamba":
        return {"mamba": group("mamba", L.init_mamba)}
    if kind == "mlstm":
        return {"mlstm": group("mlstm", L.init_mlstm)}
    if kind == "slstm":
        return {"slstm": group("slstm", L.init_slstm)}
    if kind == "dec":
        return {"attn": group("attn", L.init_attention),
                "cross": group("cross", L.init_cross_attention),
                "mlp": group("mlp", L.init_mlp)}
    raise ValueError(kind)


def init(cfg: ModelConfig, seed: int = 0, device="cuda",
         expert_dtype: Optional[torch.dtype] = None, keep: InitKeep = None) -> Params:
    """Random weights in the reference's layout, drawn from a seeded
    `torch.Generator` on `device` (not the reference's numbers: parity tests
    carry the reference's weights over with `convert.params_from_reference`).
    f32 masters, except the MoE expert stacks, which are stored in
    `expert_dtype`, by default the compute dtype (`layers.init_moe`); the
    trainer asks for f32.

    `keep(axes, leaf)`, when given, receives each leaf as soon as it is
    drawn, with its logical axes (`param_specs`), and the tree holds what
    it returns: a sharded init keeps the rank's shard, so that a rank holds
    at most one whole leaf (`runtime.trainer.sharded_init`).  The draws,
    and their order, are the same either way."""
    device = require_device(device)
    # a "meta" device (`init_abstract`) has no generator of its own
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    specs = param_specs(cfg)
    top = _keep_group(keep, specs) or (lambda name, t: t)
    emb_scale = cfg.d_model ** -0.5
    p: Params = {}
    p["embed"] = top("embed", torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                                          device=device).mul_(emb_scale))
    if not cfg.tie_embeddings:
        p["lm_head"] = top("lm_head", torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                                                  device=device).mul_(emb_scale))
    p["final_norm"] = top("final_norm", torch.zeros((cfg.d_model,), device=device))
    p["stages"] = []
    for repeat, kinds in stages(cfg):
        sp = {}
        for j, kind in enumerate(kinds):
            sp[f"{kind}_{j}"] = _init_blocks(cfg, kind, gen, device, repeat, expert_dtype, keep)
        p["stages"].append(sp)
    if has_shared_attn(cfg):
        p["shared_attn"] = L.init_attention(cfg, gen, device=device,
                                            keep=_keep_group(keep, specs["shared_attn"]))
    if cfg.encoder_layers:
        enc = specs["encoder"]
        p["encoder"] = {"blocks": _init_blocks(cfg, "enc", gen, device, cfg.encoder_layers,
                                               keep=keep),
                        "norm": (_keep_group(keep, enc) or (lambda name, t: t))(
                            "norm", torch.zeros((cfg.d_model,), device=device))}
    return p


# ---------------------------------------------------------------------------
# logical-axis spec trees (the sharding rules' input, `parallel.sharding`)
# ---------------------------------------------------------------------------

_ATTN_SPECS = {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
               "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed"),
               "norm": (None,)}
# the logical axes of each leaf of a block's parameter groups
_GROUP_SPECS = {
    "attn": _ATTN_SPECS,
    "cross": _ATTN_SPECS,
    "mlp": {"wi": ("embed", "ffn"), "wg": ("embed", "ffn"), "wo": ("ffn", "embed"),
            "norm": (None,)},
    "moe": {"router": ("embed", None), "wi": ("experts", "embed", "ffn"),
            "wg": ("experts", "embed", "ffn"), "wo": ("experts", "ffn", "embed"),
            "norm": (None,)},
    "mamba": {"in_proj": ("embed", "ffn"), "conv": (None, "ffn"), "A_log": (None,),
              "D": (None,), "dt_bias": (None,), "out_proj": ("ffn", "embed"),
              "norm": (None,), "gate_norm": (None,)},
    "mlstm": {"wqkv": ("embed", "ffn"), "wif": ("embed", None), "wo": ("ffn", "embed"),
              "norm": (None,)},
    "slstm": {"wx": ("embed", "ffn"), "wr": ("embed", "ffn"), "bias": (None,),
              "wo": ("embed", "embed"), "norm": (None,)},
}


def block_groups(cfg: ModelConfig, kind: str) -> Tuple[str, ...]:
    """The parameter groups a block of `kind` holds (shared_attn holds none:
    its parameters live once, at the top of the tree)."""
    if kind in ("attn", "local", "global", "enc"):
        return ("attn", "mlp") if cfg.d_ff else ("attn",)
    if kind == "dec":
        return ("attn", "cross", "mlp")
    if kind == "moe":
        return ("attn", "moe")
    if kind == "shared_attn":
        return ()
    return (kind,)


def _stacked_specs(cfg: ModelConfig, kind: str) -> Params:
    return {g: {leaf: ("layers",) + axes for leaf, axes in _GROUP_SPECS[g].items()}
            for g in block_groups(cfg, kind)}


def param_specs(cfg: ModelConfig) -> Params:
    """The logical-axis spec tree of `init`'s parameters: one tuple of axis
    names (or None) per leaf dimension, "layers" first in the stacks."""
    s: Params = {"embed": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        s["lm_head"] = ("embed", "vocab")
    s["final_norm"] = (None,)
    s["stages"] = [{f"{kind}_{j}": _stacked_specs(cfg, kind) for j, kind in enumerate(kinds)}
                   for _, kinds in stages(cfg)]
    if has_shared_attn(cfg):
        s["shared_attn"] = dict(_ATTN_SPECS)
    if cfg.encoder_layers:
        s["encoder"] = {"blocks": _stacked_specs(cfg, "enc"), "norm": (None,)}
    return s


# the logical axes whose `model` slice a block computes on under the
# tensor-parallel split, by parameter group; the recurrent blocks (mamba,
# mlstm, slstm) and the router compute on whole weights
_TP_AXES = {"attn": ("heads", "kv_heads"), "cross": ("heads", "kv_heads"),
            "mlp": ("ffn",), "moe": ("experts", "ffn")}


def tp_split_specs(cfg: ModelConfig) -> Params:
    """`param_specs`' tree with, at each leaf, the logical axes whose
    `model` slice the model computes on under the split (empty where it
    takes the weight whole): the attention's heads (zamba2's shared block
    and the encoder's included), the MLP's `ffn`, the experts (or their
    `ffn`), the vocabulary of the embedding and the head."""
    def group(g, specs):
        axes = _TP_AXES.get(g, ())
        return {leaf: tuple(a for a in spec if a in axes) if g != "moe" or leaf != "router"
                else () for leaf, spec in specs.items()}

    def stacked(kind):
        return {g: group(g, _GROUP_SPECS[g]) for g in block_groups(cfg, kind)}

    s: Params = {"embed": ("vocab",)}
    if not cfg.tie_embeddings:
        s["lm_head"] = ("vocab",)
    s["final_norm"] = ()
    s["stages"] = [{f"{kind}_{j}": stacked(kind) for j, kind in enumerate(kinds)}
                   for _, kinds in stages(cfg)]
    if has_shared_attn(cfg):
        s["shared_attn"] = group("attn", _ATTN_SPECS)
    if cfg.encoder_layers:
        s["encoder"] = {"blocks": stacked("enc"), "norm": ()}
    return s


def init_abstract(cfg: ModelConfig):
    """(parameters on the "meta" device: shapes and f32 dtypes, no storage;
    their spec tree), so that a 314B-parameter tree costs nothing."""
    return init(cfg, device="meta", expert_dtype=torch.float32), param_specs(cfg)


def _kind_cache_specs(kind: str) -> Params:
    if kind in _ATTN_KINDS:
        kv = ("batch", "kv_heads", "cache", "head_dim")
        return {"k": kv, "v": kv}
    if kind == "mamba":
        return {"state": ("batch", None, None, None), "conv": ("batch", None, "ffn")}
    if kind == "mlstm":
        return {"C": ("batch", None, None), "n": ("batch", None, None)}
    if kind == "slstm":
        return {k: ("batch", None) for k in ("h", "c", "n", "m")}
    raise ValueError(kind)


def cache_specs(cfg: ModelConfig) -> list:
    """The logical-axis spec tree of `init_cache`'s serving cache."""
    return [{f"{kind}_{j}": {k: ("layers",) + axes for k, axes in _kind_cache_specs(kind).items()}
             for j, kind in enumerate(kinds)} for _, kinds in stages(cfg)]


def init_cache_abstract(cfg: ModelConfig, batch: int, cache_len: int):
    """(the serving cache on the "meta" device, its spec tree)."""
    return init_cache(cfg, batch, cache_len, device="meta"), cache_specs(cfg)


def has_shared_attn(cfg: ModelConfig) -> bool:
    """True when the model holds zamba2's one shared attention block."""
    return any("shared_attn" in kinds for _, kinds in stages(cfg))


def params_device(params: Params) -> torch.device:
    return params["embed"].device


def check_params_device(params: Params, device) -> torch.device:
    """Resolve `device` (raising without a card) and require that `params`
    lie on that kind of device."""
    device = require_device(device)
    have = params_device(params)
    if have.type != device.type:
        raise ValueError(f"parameters lie on {have} but device={device} was requested")
    return have


def _stack_depth(tree: Params) -> Optional[int]:
    """The leading (layer) axis of the first leaf of a layer-stacked tree."""
    for v in tree.values():
        d = _stack_depth(v) if isinstance(v, dict) else v.shape[0]
        if d is not None:
            return d
    return None


def check_params_layout(cfg: ModelConfig, params: Params) -> None:
    """Require that `params` hold, stage by stage, the layer counts of
    `cfg`'s layout (`stages`) and its encoder's depth, so that weights built
    for a depth-cut config and run with another raise here, naming both, and
    not deep in `_layer`."""
    want = [repeat for repeat, _ in stages(cfg)]
    have = [_stack_depth(sp) for sp in params["stages"]]
    if have != want:
        raise ValueError(f"{cfg.name}: the config has stages of {want} layers, "
                         f"the parameters {have}")
    enc = _stack_depth(params["encoder"]["blocks"]) if "encoder" in params else 0
    if enc != cfg.encoder_layers:
        raise ValueError(f"{cfg.name}: the config has {cfg.encoder_layers} encoder layers, "
                         f"the parameters {enc}")


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _kind_cache(cfg: ModelConfig, kind: str, repeat: int, batch: int, cache_len: int,
                device, local: Optional[Callable[[Tuple[int, ...]], Tuple[int, ...]]] = None
                ) -> Params:
    """The zeroed cache of `repeat` blocks of one kind, layer axis first;
    `local(shape)`, when given, maps each leaf's shape to the shape of the
    part of it this rank holds (a sharded serving step's cache)."""
    dt = L.compute_dtype(cfg)
    f32 = torch.float32

    def zeros(*shape, dtype=f32):
        shape = (repeat,) + shape
        return torch.zeros(shape if local is None else local(shape), dtype=dtype, device=device)

    if kind in _ATTN_KINDS:
        w = _kind_window(cfg, kind)
        length = min(w, cache_len) if w else cache_len
        shape = (batch, cfg.n_kv_heads, length, cfg.head_dim_)
        return {"k": zeros(*shape, dtype=dt), "v": zeros(*shape, dtype=dt)}
    if kind == "mamba":
        return {"state": zeros(batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                "conv": zeros(batch, cfg.conv_width - 1, cfg.d_inner, dtype=dt)}
    if kind == "mlstm":  # batch and heads fused on one axis
        h, dh = cfg.n_heads, cfg.head_dim_
        return {"C": zeros(batch * h, dh, dh), "n": zeros(batch * h, 1, dh)}
    if kind == "slstm":
        m = cfg.d_model
        return {"h": zeros(batch, m), "c": zeros(batch, m), "n": zeros(batch, m),
                "m": zeros(batch, m).fill_(-10.0)}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device="cuda"):
    """Zeroed serving cache: per stage, per block name, the leaves of that
    kind with a leading layer axis and batch next.  Attention kinds keep
    {'k','v'} (layers, batch, kv_heads, length, head_dim), windowed kinds at
    most `window` positions; mamba {'state' f32, 'conv'}; mlstm {'C','n'}
    f32 with batch*heads fused; slstm {'h','c','n','m'} f32, 'm' at -10.
    Under a sharded serving step's `cache_layout` each leaf is the rank's
    shard of the global cache (of the layout's global batch: `batch`, the
    rank's rows, is not read)."""
    device = require_device(device)
    cache = []
    for si, (repeat, kinds) in enumerate(stages(cfg)):
        sc = {}
        for j, kind in enumerate(kinds):
            name = f"{kind}_{j}"
            local = None
            if _CACHE_LAYOUT is not None:
                batch = _CACHE_LAYOUT.batch
                local = _CACHE_LAYOUT.local_shape_fn(si, name)
            sc[name] = _kind_cache(cfg, kind, repeat, batch, cache_len, device, local)
        cache.append(sc)
    return cache


class CacheLayout:
    """How a sharded serving step's rank holds the cache
    (`serve.sharded`): `specs`, `init_cache`'s tree of `PartitionSpec`s (a
    leaf's dimensions, the layer axis first), for a global batch of
    `batch` rows over a mesh of axis sizes `sizes`.  What each block reads
    of it is worked out once here, not at every step: `kv_spec[si, name]`,
    an attention block's K/V spec without the layer axis, where the length
    splits over ranks (else None: the block's cache is laid out as on one
    device along its length); `state_split[si, name]`, a recurrent block's
    {leaf: ((dim, axes), ...)} split on a dimension other than the batch
    (empty where nothing is, the block computing on its views as they
    are)."""

    def __init__(self, specs, batch: int, sizes: Dict[str, int]):
        self.specs, self.batch, self.sizes = specs, batch, sizes
        self.kv_spec, self.state_split = {}, {}
        for si, stage in enumerate(specs):
            for name, leaves in stage.items():
                block = {k: tuple(sp)[1:] for k, sp in leaves.items()}
                if "k" in block:
                    length = actx.axes_of(block["k"][2] if len(block["k"]) > 2 else None)
                    self.kv_spec[si, name] = block["k"] if self._size(length) > 1 else None
                    continue
                split = {}
                for k, sp in block.items():
                    dims = tuple((d, actx.axes_of(part)) for d, part in enumerate(sp)
                                 if d > 0 and self._size(actx.axes_of(part)) > 1)
                    if dims:
                        split[k] = dims
                self.state_split[si, name] = split

    def _size(self, axes: Tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= self.sizes[a]
        return n

    def local_shape_fn(self, si: int, name: str):
        """`shape -> the rank's shape` for the leaves of one block, matched
        by their place in `_kind_cache`'s order of drawing."""
        specs = iter(self.specs[si][name].values())

        def local(shape):
            spec = tuple(next(specs)) + (None,) * len(shape)
            return tuple(d // self._size(actx.axes_of(part)) for d, part in zip(shape, spec))
        return local


# the sharded serving step's cache layout (`serve.sharded`); None: the
# rank holds the whole cache (one device)
_CACHE_LAYOUT: Optional[CacheLayout] = None


@contextlib.contextmanager
def cache_layout(layout: Optional[CacheLayout]):
    """Within the context, `init_cache` makes the rank's shards and each
    block reads and writes its cache as `layout` splits it."""
    global _CACHE_LAYOUT
    prev, _CACHE_LAYOUT = _CACHE_LAYOUT, layout
    try:
        yield
    finally:
        _CACHE_LAYOUT = prev


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _apply_block(cfg: ModelConfig, kind: str, p: Params, x, positions, *,
                 shared: Optional[Params], cache, cache_pos, cache_pos_max, enc_out,
                 cache_spec=None):
    """Returns (x, cache, aux); the cache views are updated in place, and
    aux is None for the kinds that have no auxiliary loss.  `enc` and `dec`
    come first: both are attention kinds, and the generic branch below
    would drop the decoder's cross-attention.  `cache_spec`: how a sharded
    serving step splits an attention block's K/V (`layers.apply_attention`)."""
    if kind == "enc":
        x, _ = L.apply_attention(cfg, p["attn"], x, positions, causal=False)
        return L.apply_mlp(cfg, p["mlp"], x), None, None
    if kind == "dec":
        x, nc = L.apply_attention(cfg, p["attn"], x, positions, cache=cache,
                                  cache_pos=cache_pos, cache_pos_max=cache_pos_max,
                                  cache_spec=cache_spec)
        x = L.apply_cross_attention(cfg, p["cross"], x, enc_out)
        return L.apply_mlp(cfg, p["mlp"], x), nc, None
    if kind in _ATTN_KINDS:
        w = _kind_window(cfg, kind)
        x, nc = L.apply_attention(cfg, shared if kind == "shared_attn" else p["attn"], x,
                                  positions, window=w, cache=cache, cache_pos=cache_pos,
                                  cache_pos_max=cache_pos_max, cache_spec=cache_spec)
        if kind == "moe":
            x, aux = L.apply_moe(cfg, p["moe"], x)
            return x, nc, aux
        if "mlp" in p:
            x = L.apply_mlp(cfg, p["mlp"], x)
        return x, nc, None
    if kind == "mamba":
        return (*L.apply_mamba(cfg, p["mamba"], x, cache=cache), None)
    if kind == "mlstm":
        return (*L.apply_mlstm(cfg, p["mlstm"], x, cache=cache), None)
    if kind == "slstm":
        return (*L.apply_slstm(cfg, p["slstm"], x, cache=cache), None)
    raise ValueError(kind)


class _WholeState(dict):
    """A recurrent block's cache made whole along the dimensions other than
    the batch that a sharded serving step splits (`split`,
    `CacheLayout.state_split`; mamba's conv window on `ffn`, which the
    rules put on `model`): the block computes whole, as it does in
    training, and `write_back` keeps the rank's slice."""

    def __init__(self, views: Params, split: Dict[str, Tuple]):
        super().__init__(views)
        self.views, self.split = views, split
        for name, dims in split.items():
            for d, axes in dims:
                self[name] = actx.axes_gather(self[name], axes, d)

    def write_back(self) -> None:
        for name, dims in self.split.items():
            t = self[name]
            for d, axes in dims:
                size = self.views[name].shape[d]
                t = t.narrow(d, actx.axes_index(axes) * size, size)
            self.views[name].copy_(t)


def _layer(tree: Params, i: int) -> Params:
    """Views of layer `i` of a layer-stacked parameter or cache tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# the sharded train step's parameter gather (`runtime.trainer`): called as
# `fn(tree, i)`, it gives the whole tensors of `tree`'s leaves (of layer `i`
# of a layer-stacked tree when `i` is not None) from this rank's shards;
# None (one device) takes the leaves as they are
_PARAM_GATHER: Optional[Callable[..., Any]] = None


@contextlib.contextmanager
def param_gather(fn: Optional[Callable[..., Any]]):
    """Within the context, every parameter is made whole by `fn` where the
    forward uses it (`_gathered`)."""
    global _PARAM_GATHER
    prev, _PARAM_GATHER = _PARAM_GATHER, fn
    try:
        yield
    finally:
        _PARAM_GATHER = prev


def _gathered(tree, i: Optional[int] = None):
    """`tree` (layer `i` of it when `i` is not None) as the forward uses it:
    the whole weights under a sharded step's gather, else the leaves (or
    `_layer`'s views) themselves.  The gather passes a tensor it did not
    shard through, so a weight gathered once and handed on is not
    gathered again."""
    if _PARAM_GATHER is None:
        return tree if i is None else _layer(tree, i)
    return _PARAM_GATHER(tree, i)


def _with_gathered(params: Params, *names: str) -> Params:
    """`params` with its top-level leaves `names` gathered (a shallow copy
    under a sharded step's gather; `params` itself without one)."""
    if _PARAM_GATHER is None:
        return params
    return dict(params, **{n: _gathered(params[n]) for n in names if n in params})


def _remat_on(cfg: ModelConfig, params: Params) -> bool:
    """True when `cfg.remat` applies: a backward can follow this forward
    (grad enabled, and the weights require it)."""
    return cfg.remat != "none" and torch.is_grad_enabled() and params["embed"].requires_grad


def _checkpoint(fn, *args):
    """`fn(*args)` with its activations recomputed in the backward."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def _run_stages(cfg: ModelConfig, params: Params, x, positions, *,
                cache=None, cache_pos=None, cache_pos_max: int = 0, enc_out=None):
    """Run every stage, layer by layer; `dec` blocks attend to `enc_out`.
    `cache`, when given, is updated in place (each block writes into its
    layer's view).  Without a cache and under `cfg.remat`, each repeat of a
    stage runs under one checkpoint.  Returns (x, cache,
    aux), aux the sum of the blocks' auxiliary losses (an f32 scalar, or
    None when no block has one).  Weights whose layout is not `cfg`'s raise
    `ValueError` (`check_params_layout`)."""
    check_params_layout(cfg, params)
    # used by every shared_attn block: gathered once, outside the checkpoints
    shared = _gathered(params.get("shared_attn"))
    remat = cache is None and _remat_on(cfg, params)
    aux_total = None
    for si, (repeat, kinds) in enumerate(stages(cfg)):
        sp = params["stages"][si]
        scache = cache[si] if cache is not None else None
        paired = W.has_pair(sp)

        def body(x, i, si=si, sp=sp, scache=scache, kinds=kinds, paired=paired):
            layer_p = _gathered(sp, i)
            if paired:      # int8 wire pairs dequantize at body entry, as in the reference
                layer_p = W.dequant_subtree(layer_p, L.compute_dtype(cfg))
            aux_sum = None
            for j, kind in enumerate(kinds):
                name = f"{kind}_{j}"
                c_j = _layer(scache[name], i) if scache is not None else None
                spec = None
                if c_j is not None and _CACHE_LAYOUT is not None:
                    if kind in _ATTN_KINDS:
                        spec = _CACHE_LAYOUT.kv_spec[si, name]
                    elif _CACHE_LAYOUT.state_split[si, name]:
                        c_j = _WholeState(c_j, _CACHE_LAYOUT.state_split[si, name])
                x, _, aux = _apply_block(cfg, kind, layer_p.get(name, {}), x, positions,
                                         shared=shared, cache=c_j, cache_pos=cache_pos,
                                         cache_pos_max=cache_pos_max, enc_out=enc_out,
                                         cache_spec=spec)
                if isinstance(c_j, _WholeState):
                    c_j.write_back()
                if aux is not None:
                    aux_sum = aux if aux_sum is None else aux_sum + aux
            return x, aux_sum

        for i in range(repeat):
            x, aux = _checkpoint(body, x, i) if remat else body(x, i)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
    return x, cache, aux_total


# ---------------------------------------------------------------------------
# embedding / heads
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor):
    table, dt = _gathered(params["embed"]), L.compute_dtype(cfg)
    split = table.shape[0] < cfg.vocab           # this rank's rows of a split table
    if split:
        lo = actx.tp_rank() * table.shape[0]
        mine = (tokens >= lo) & (tokens < lo + table.shape[0])
        tokens = torch.clamp(tokens - lo, 0, table.shape[0] - 1)
    if table.dtype.itemsize < dt.itemsize:
        # a table narrower than the compute dtype (the parameter wire's
        # bf16 under f32 compute): widen it first, as the reference does,
        # so that its gradient sums in the compute dtype
        x = table.to(dt)[tokens]
    else:
        # index first, then cast: the same values as casting the whole table
        x = table[tokens].to(dt)
    if split:
        x = actx.tp_sum(torch.where(mine[..., None], x, 0))
    return x


def logits_head(cfg: ModelConfig, params: Params, h: torch.Tensor):
    """(B, S, V) f32 logits; under a split of the vocabulary this rank's
    columns of them."""
    w = _gathered(params["embed"]).t() if cfg.tie_embeddings else _gathered(params["lm_head"])
    if w.shape[-1] < cfg.vocab:
        return L.linear(cfg, w, actx.tp_copy(h), "cols").to(torch.float32)
    return L.linear(cfg, w, h).to(torch.float32)


def _split_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """sum(logsumexp - gold logit) of logits split by vocabulary over the
    split's ranks (this rank's columns given): the max, the sum of
    exponentials and the gold logit, each summed (or maxed) over the split."""
    vl = logits.shape[-1]
    lo = actx.tp_rank() * vl
    top = actx.tp_max(torch.amax(logits.detach(), dim=-1))
    sumexp = actx.tp_sum(torch.sum(torch.exp(logits - top[..., None]), dim=-1))
    mine = (labels >= lo) & (labels < lo + vl)
    gold = torch.gather(logits, -1, torch.clamp(labels - lo, 0, vl - 1)[..., None])[..., 0]
    gold = actx.tp_sum(torch.where(mine, gold, 0))
    return torch.sum(top + torch.log(sumexp) - gold)


def default_positions(cfg: ModelConfig, batch: int, seq: int, offset=0, device="cuda"):
    """offset: scalar, or (B,) vector (continuous batching: per-slot
    positions).  (B, S), or for M-RoPE (3, B, S) with the token index on all
    three streams, as the reference gives text and decode positions."""
    off = torch.as_tensor(offset, dtype=torch.int32, device=device)
    if off.ndim == 1:
        off = off[:, None]
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + off
    pos = torch.broadcast_to(pos, (batch, seq))
    if cfg.mrope:
        return torch.broadcast_to(pos[None], (3, batch, seq))
    return pos


# ---------------------------------------------------------------------------
# encoder (seamless)
# ---------------------------------------------------------------------------


def encode(cfg: ModelConfig, params: Params, enc_embeds, device="cuda") -> torch.Tensor:
    """enc_embeds: precomputed audio-frontend frames (B, Se, M), a tensor or
    numpy array (the modality frontend is a stub, as in the reference).
    Positions 0 .. Se-1, the encoder blocks layer by layer, then the
    encoder's norm.  Returns enc_out (B, Se, M) in the compute dtype."""
    device = check_params_device(params, device)
    check_params_layout(cfg, params)
    x = torch.as_tensor(enc_embeds).to(device=device, dtype=L.compute_dtype(cfg))
    b, se, _ = x.shape
    positions = torch.arange(se, dtype=torch.int32, device=device)[None].expand(b, se)
    blocks = params["encoder"]["blocks"]
    remat = _remat_on(cfg, params)
    paired = W.has_pair(blocks)

    def layer(x, i):
        layer_p = _gathered(blocks, i)
        if paired:
            layer_p = W.dequant_subtree(layer_p, L.compute_dtype(cfg))
        return _apply_block(cfg, "enc", layer_p, x, positions, shared=None,
                            cache=None, cache_pos=None, cache_pos_max=0, enc_out=None)[0]

    with span("encode"):
        for i in range(cfg.encoder_layers):
            x = _checkpoint(layer, x, i) if remat else layer(x, i)
        return L.rms_norm(x, _gathered(params["encoder"]["norm"]))


def _batch_enc_out(cfg: ModelConfig, params: Params, batch: Dict[str, Any], device):
    """The encoder's output for `batch["enc_embeds"]`, or None without an
    encoder."""
    if not cfg.encoder_layers:
        return None
    if batch.get("enc_embeds") is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder config needs batch['enc_embeds']")
    return encode(cfg, params, batch["enc_embeds"], device=device)


# ---------------------------------------------------------------------------
# train / serve entry points
# ---------------------------------------------------------------------------


def _tokens(batch: Dict[str, Any], device) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"]).to(device=device, dtype=torch.long)


def forward_hidden(cfg: ModelConfig, params: Params, batch: Dict[str, Any], device="cuda"):
    """Full-sequence forward.  Returns (hidden (B,S,M), aux); `aux` is the
    sum of the blocks' auxiliary losses (the MoE load-balance and router
    z-losses; zero for the other kinds).  A vision config replaces the
    first npix embeddings with `batch["pixel_embeds"]` (B, npix, M) when
    given; an encoder-decoder config encodes `batch["enc_embeds"]` first."""
    device = check_params_device(params, device)
    tokens = _tokens(batch, device)
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    if cfg.frontend == "vision" and batch.get("pixel_embeds") is not None:
        pix = torch.as_tensor(batch["pixel_embeds"]).to(device=device, dtype=x.dtype)
        x = torch.cat([pix, x[:, pix.shape[1]:]], dim=1)
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(cfg, b, s, device=device)
    else:
        positions = torch.as_tensor(positions).to(device)
    enc_out = _batch_enc_out(cfg, params, batch, device)
    x, _, aux = _run_stages(cfg, params, x, positions, enc_out=enc_out)
    if aux is None:
        aux = torch.zeros((), device=device)
    return L.rms_norm(x, _gathered(params["final_norm"])), aux


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, Any], device="cuda"):
    """Chunked cross-entropy plus 1e-2 of the blocks' auxiliary loss.
    Logits are made one `cfg.loss_chunk` slice of the sequence at a time
    (under `cfg.remat`, each chunk's head is recomputed in the backward), so
    the (B,S,V) tensor never exists.  `batch["labels"]` (B,S) holds the
    next token of each position.  Returns (loss, {"ce", "aux"}), f32
    scalars; ce is the summed `logsumexp - gold logit` over B*S.  Under a
    sharded step's gather the head is gathered once for every chunk, and a
    tied embedding once for the embedding and the head."""
    if cfg.tie_embeddings:
        params = _with_gathered(params, "embed")
    h, aux = forward_hidden(cfg, params, batch, device=device)
    params = _with_gathered(params, "lm_head")
    labels = torch.as_tensor(batch["labels"]).to(device=h.device, dtype=torch.long)
    b, s, _ = h.shape
    chunk = min(cfg.loss_chunk, s)
    if s % chunk:
        raise ValueError(f"{cfg.name}: sequence {s} is not a multiple of loss_chunk {chunk}")

    def chunk_ce(hx, yx):
        logits = logits_head(cfg, params, hx)                       # (B, chunk, V) f32
        if logits.shape[-1] < cfg.vocab:                            # split by vocabulary
            return _split_ce(logits, yx)
        gold = torch.gather(logits, -1, yx[..., None])[..., 0]
        return torch.sum(torch.logsumexp(logits, dim=-1) - gold)

    remat = _remat_on(cfg, params)
    sums = []
    for c0 in range(0, s, chunk):
        hx, yx = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        sums.append(_checkpoint(chunk_ce, hx, yx) if remat else chunk_ce(hx, yx))
    ce = torch.stack(sums).sum() / (b * s)
    return ce + 1e-2 * aux, {"ce": ce, "aux": aux}


def train_logits(cfg: ModelConfig, params: Params, batch, device="cuda"):
    """Small-scale helper (tests/examples): full logits (B,S,V) f32."""
    h, _ = forward_hidden(cfg, params, batch, device=device)
    return logits_head(cfg, params, h)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            cache_len: Optional[int] = None, device="cuda"):
    """Run the full prompt, return (last_logits (B,1,V), cache).  `cache_len`
    sizes the KV cache (>= prompt length; default prompt + 1 so at least one
    decode step fits).  An encoder-decoder config encodes
    `batch["enc_embeds"]` here; the decode steps after it take the
    encoder's output from the caller (`serve_step(enc_out=)`).  Like the
    reference's, it ignores `batch["pixel_embeds"]`: only `forward_hidden`
    splices them in (ROADMAP.md, Queue 3)."""
    device = check_params_device(params, device)
    tokens = _tokens(batch, device)
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(cfg, b, s, device=device)
    else:
        positions = torch.as_tensor(positions).to(device)
    enc_out = _batch_enc_out(cfg, params, batch, device)
    cache = init_cache(cfg, b, cache_len or (s + 1), device=device)
    x, cache, _ = _run_stages(cfg, params, x, positions, cache=cache, cache_pos=0,
                              enc_out=enc_out)
    h = L.rms_norm(x[:, -1:], _gathered(params["final_norm"]))
    return logits_head(cfg, params, h), cache


@torch.no_grad()
def serve_step(cfg: ModelConfig, params: Params, cache, tokens, pos, enc_out=None,
               device="cuda"):
    """One decode step: tokens (B,1) at absolute position `pos`, a scalar or
    a (B,) vector (int, numpy array or tensor; a CUDA tensor costs one
    synchronisation, because the host must know whether a cache rolls).
    An encoder-decoder config needs `enc_out` (B, Se, M), the encoder's
    output (`encode`).  Returns (logits (B,1,V), cache); the cache is
    updated in place."""
    device = check_params_device(params, device)
    if cfg.encoder_layers and enc_out is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder config decodes against enc_out")
    tokens = torch.as_tensor(tokens).to(device=device, dtype=torch.long)
    b = tokens.shape[0]
    pos_host = pos.detach().cpu().numpy() if isinstance(pos, torch.Tensor) else np.asarray(pos)
    pos_dev = torch.as_tensor(pos_host.astype(np.int64), device=device)
    x = embed_tokens(cfg, params, tokens)
    positions = default_positions(cfg, b, 1, offset=pos_dev, device=device)
    x, cache, _ = _run_stages(cfg, params, x, positions, cache=cache, cache_pos=pos_dev,
                              cache_pos_max=int(pos_host.max()), enc_out=enc_out)
    h = L.rms_norm(x, _gathered(params["final_norm"]))
    return logits_head(cfg, params, h), cache
