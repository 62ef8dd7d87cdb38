"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP).

The counterpart of the JAX package's `parallel/sharding.py`.  Parameters,
optimizer state and caches carry logical-axis spec trees ("embed",
"heads", "ffn", "vocab", "experts", ...; `models.model.init_abstract`,
`init_cache_abstract`, `optim.adamw.state_specs`); this module maps them
onto mesh axes with per-architecture and per-shape decisions, enforcing
divisibility (an axis that does not divide falls back to the next rule or
to replication: yi-34b's 56 heads cannot split 16 ways, so its attention
shards `head_dim` instead; seamless's 256206 vocab stays replicated).

The layer has three parts:
  * the rules and the partition specs (`rules_for`, `spec_to_pspec`,
    `tree_pspecs`, `batch_axes`, `batch_pspec`, `fix_pspec_for_shape`)
    read a mesh's geometry alone: a `DeviceMesh`, or a
    `parallel.collectives.MeshGeometry`, so that the production meshes of
    256 and 512 devices are reasoned about with no process group;
  * `NamedSharding` pairs a mesh with a `PartitionSpec`, as the
    reference's does (`tree_shardings`, `train_batch_shardings`,
    `cache_shardings`, `enforce_divisibility`);
  * `placements` turns a spec into DTensor placements over a
    `DeviceMesh`: a dimension on ("pod", "data") becomes `Shard(d)` on
    both mesh dimensions, which DTensor splits pod-major, as the reference
    lays the flattened axes out.  Every config's `fsdp_axes` is pod-major.
    `shard_index` and `local_shard` give a rank's block of that layout,
    `owns_shard` the one rank that counts (or writes) a block several
    ranks hold.

The mapping follows the paper: `data` is the memory-chiplet side (FSDP
parameter all-gathers and gradient reductions), `model` the compute-chiplet
side, and `pod` the cross-subnetwork axis whose stage count the TRINE
collectives minimize.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch import tree as T
from repro_torch.parallel.collectives import mesh_axis_sizes
from repro_torch.models.config import ModelConfig

__all__ = ["PartitionSpec", "P", "NamedSharding", "rules_for", "spec_to_pspec", "is_axes_leaf",
           "tree_pspecs", "tree_shardings", "batch_axes", "batch_pspec",
           "train_batch_shardings", "cache_shardings", "fix_pspec_for_shape",
           "enforce_divisibility", "placements", "shard_index", "local_shard", "owns_shard"]


def _canonical(part):
    """An entry as the reference's `PartitionSpec` stores it: a one-name
    tuple as the name, an empty one as None."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return None if not part else part[0] if len(part) == 1 else part
    return part


class PartitionSpec(tuple):
    """Mesh axes per tensor dimension: None (replicated), an axis name, or a
    tuple of axis names (major first).  Trailing dimensions not listed are
    replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canonical(p) for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A mesh (a `DeviceMesh` or a geometry) and a `PartitionSpec`."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    def __repr__(self) -> str:
        return f"NamedSharding({mesh_axis_sizes(self.mesh)}, {self.spec!r})"


def _axis_size(mesh, axes) -> int:
    sizes = mesh_axis_sizes(mesh)
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes[axes]
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def rules_for(cfg: ModelConfig, mesh, strategy: Optional[str] = None) -> Dict[str, Any]:
    """Logical axis -> mesh axes (None = replicate), validated against cfg.

    Strategies:
      tp_fsdp  Megatron TP on `model` + FSDP on fsdp_axes (baseline).
      fsdp_all ZeRO-3 over the whole mesh; batch also spans `model`.
      seq_tp   FSDP + TP MLP, attention context-parallel (sequence over
               `model`): no head-count constraint.
    """
    strategy = strategy or cfg.parallel_strategy
    names = mesh_axis_sizes(mesh)
    fsdp = tuple(a for a in cfg.fsdp_axes if a in names) or ("data",)
    tp = "model"
    tp_n = _axis_size(mesh, tp)

    if strategy == "fsdp_all":
        full = tuple(a for a in ("pod", "data", "model") if a in names)
        return {
            "layers": None,
            "embed": full if cfg.d_model % _axis_size(mesh, full) == 0 else fsdp,
            "ffn": None, "vocab": None, "experts": None,
            "batch": None, "cache": None,
            "head_dim": None, "kv_heads": None, "heads": None,
        }

    rules: Dict[str, Any] = {
        "layers": None,
        "embed": fsdp,
        "ffn": tp,
        "vocab": tp if cfg.vocab % tp_n == 0 else None,
        "experts": tp if cfg.n_experts and cfg.n_experts % tp_n == 0 else None,
        "batch": None,   # set per shape by the batch rules
        "cache": None,
        "head_dim": None,
        "kv_heads": None,
        "heads": None,
    }
    if strategy == "seq_tp":
        # attention weights replicated over `model`; the sequence carries the TP
        return rules
    # attention TP: prefer heads; fall back to head_dim (contraction sharding)
    if cfg.n_heads % tp_n == 0:
        rules["heads"] = tp
        if cfg.n_kv_heads % tp_n == 0:
            rules["kv_heads"] = tp
    elif cfg.head_dim_ % tp_n == 0:
        rules["head_dim"] = tp
    # experts sharded over tp -> per-expert ffn must stay replicated on tp
    if rules["experts"] == tp:
        rules["ffn"] = None
    if cfg.d_ff and rules["ffn"] == tp and cfg.d_ff % tp_n != 0:
        rules["ffn"] = None
    return rules


def spec_to_pspec(axes: Optional[Tuple], rules: Dict[str, Any]) -> PartitionSpec:
    """A leaf's logical axes -> its `PartitionSpec`; a mesh axis is used by
    the first dimension that asks for it, and later ones replicate."""
    if axes is None:
        return P()
    out = []
    used: set = set()

    def usable(m):
        if m is None:
            return None
        ms = (m,) if isinstance(m, str) else tuple(m)
        if any(x in used for x in ms):
            return None
        used.update(ms)
        return m

    for ax in axes:
        out.append(usable(rules.get(ax)) if ax is not None else None)
    return P(*out)


def is_axes_leaf(x) -> bool:
    """A spec leaf is None or a tuple of axis names/None, not an arbitrary
    tuple (a TrainState is a NamedTuple and is recursed into)."""
    return x is None or (
        isinstance(x, tuple)
        and not hasattr(x, "_fields")
        and all(e is None or isinstance(e, str) for e in x)
    )


def _map_specs(fn, spec_tree):
    """`fn` over the axes leaves of a spec tree."""
    if is_axes_leaf(spec_tree):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(_map_specs(fn, v) for v in spec_tree))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(_map_specs(fn, v) for v in spec_tree)
    raise TypeError(f"not a spec tree node: {spec_tree!r}")


def tree_pspecs(spec_tree, rules):
    return _map_specs(lambda axes: spec_to_pspec(axes, rules), spec_tree)


def tree_shardings(mesh, spec_tree, rules):
    return _map_specs(lambda axes: NamedSharding(mesh, spec_to_pspec(axes, rules)), spec_tree)


# ---------------------------------------------------------------------------
# per-shape batch and cache rules
# ---------------------------------------------------------------------------


def batch_axes(mesh, global_batch: int, strategy: str = "tp_fsdp") -> Optional[Tuple[str, ...]]:
    """Largest prefix of the data-parallel axes that divides the batch
    (fsdp_all spans the model axis too)."""
    names = (("pod", "data", "model") if strategy == "fsdp_all" else ("pod", "data"))
    have = mesh_axis_sizes(mesh)
    cand = [a for a in names if a in have]
    for take in range(len(cand), 0, -1):
        axes = tuple(cand[:take])
        if global_batch % _axis_size(mesh, axes) == 0:
            return axes
    return None


def batch_pspec(mesh, batch_leaf_ndim: int, global_batch: int,
                seq_shard: bool = False) -> PartitionSpec:
    return P(batch_axes(mesh, global_batch), *([None] * (batch_leaf_ndim - 1)))


def train_batch_shardings(cfg: ModelConfig, mesh, batch_spec, strategy: str = None):
    """Shard every batch leaf on its batch dimension (the M-RoPE positions
    leaf, (3, B, S), on its second)."""
    strategy = strategy or cfg.parallel_strategy

    def leaf_sharding(leaf):
        shape = tuple(leaf.shape)
        if len(shape) >= 3 and shape[0] == 3:  # (3, B, S) M-RoPE positions
            ps = P(None, batch_axes(mesh, shape[1], strategy), *([None] * (len(shape) - 2)))
        else:
            ps = P(batch_axes(mesh, shape[0], strategy), *([None] * (len(shape) - 1)))
        return NamedSharding(mesh, ps)

    return T.map_structure(leaf_sharding, batch_spec)


def cache_shardings(cfg: ModelConfig, mesh, cache_spec, global_batch: int,
                    rules: Dict[str, Any]):
    """Decode caches.  Batch shards over (pod, data) when divisible; the KV
    head dim shards over `model` when divisible, otherwise the cache LENGTH
    takes the leftover axes (sequence-parallel / flash-decoding).  Leaves
    are then divisibility-checked (`enforce_divisibility`) by the caller,
    since recurrent-state caches have batch*heads leading dims."""
    tp_n = _axis_size(mesh, "model")
    ba = batch_axes(mesh, global_batch)
    kv_ok = cfg.n_kv_heads % tp_n == 0
    have = mesh_axis_sizes(mesh)
    seq_axes = []
    if ba is None:
        seq_axes += [a for a in ("pod", "data") if a in have]
    if not kv_ok:
        seq_axes.append("model")
    local_rules = dict(rules)
    local_rules["batch"] = ba
    local_rules["kv_heads"] = "model" if kv_ok else None
    local_rules["cache"] = tuple(seq_axes) if seq_axes else None
    return tree_shardings(mesh, cache_spec, local_rules)


def fix_pspec_for_shape(mesh, ps: PartitionSpec, shape) -> PartitionSpec:
    """Drop mesh axes from any dim of `ps` they do not divide."""
    sizes = mesh_axis_sizes(mesh)
    spec = list(ps) + [None] * (len(shape) - len(ps))
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        keep, n = [], 1
        for a in axes:
            if dim % (n * sizes[a]) == 0:
                keep.append(a)
                n *= sizes[a]
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return P(*out)


def enforce_divisibility(sharding_tree, shape_tree):
    """`fix_pspec_for_shape` leaf by leaf over a tree of `NamedSharding`s
    and a tree of the same structure whose leaves have `.shape`."""
    def fix(sh: NamedSharding, leaf):
        return NamedSharding(sh.mesh, fix_pspec_for_shape(sh.mesh, sh.spec, tuple(leaf.shape)))

    return T.map_structure(fix, sharding_tree, shape_tree)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(mesh, spec: PartitionSpec, ndim: int) -> list:
    # torch.distributed.tensor is imported where it is used: it takes about
    # a second to import, and the rules above need none of it
    """DTensor placements over `mesh`'s dimensions for a leaf of `ndim`
    dimensions sharded as `spec`: `Shard(d)` on every mesh dimension that
    dimension d names, `Replicate()` on the others.  A dimension on
    several mesh axes must name them in the mesh's order (DTensor splits
    them major first, in that order), as the reference's pod-major
    (pod, data) is."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dimension {d} is sharded on {axes}, not in the mesh's order "
                             f"{tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def shard_index(mesh, spec: PartitionSpec, shape) -> tuple:
    """The slices of a tensor of `shape` laid out as `spec` over a
    `DeviceMesh` that this rank holds: on a dimension on axes (a, b), block
    a_index * size_b + b_index of size_a * size_b equal blocks, the layout
    `placements` gives DTensor.  Raises on a dimension the axes do not
    divide (`enforce_divisibility` first)."""
    sizes = mesh_axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = [slice(None)] * len(shape)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        idx, n = 0, 1
        for a in ((ax,) if isinstance(ax, str) else ax):
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
        if shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not split {n} ways ({ax})")
        size = shape[d] // n
        index[d] = slice(idx * size, (idx + 1) * size)
    return tuple(index)


def local_shard(mesh, spec: PartitionSpec, t):
    """This rank's shard of a full tensor `t` laid out as `spec` over a
    `DeviceMesh` (a view; no communication; `shard_index`)."""
    return t[shard_index(mesh, spec, tuple(t.shape))]


def owns_shard(mesh, spec: PartitionSpec) -> bool:
    """True on the one rank of each group of ranks that hold the same shard
    of a leaf laid out as `spec`: coordinate 0 on every mesh axis the spec
    does not name."""
    used = {a for ax in spec if ax is not None for a in ((ax,) if isinstance(ax, str) else ax)}
    return all(c == 0 for name, c in zip(mesh.mesh_dim_names, mesh.get_coordinate())
               if name not in used)
