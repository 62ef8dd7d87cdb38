"""Fault-tolerant checkpointing, in the reference's on-disk format.

  * step-atomic: write to `step_XXXXXXXX.tmp/`, fsync, rename: a crash
    mid-write never corrupts the latest checkpoint,
  * content-verified: a per-leaf SHA1 in `manifest.json`, checked on restore,
  * one `.npy` per leaf, named in the manifest by its `jax.tree_util.keystr`
    path (`repro_torch.tree`), so that an f32 checkpoint written by either
    package restores in the other,
  * retention: keep the newest `keep` checkpoints.

A bf16 leaf has no numpy dtype here: its bits are stored as a uint16 array,
with "bfloat16" as its dtype in the manifest.  Restore reads such a leaf
from these files and from the reference's, which numpy loads as 2-byte
void records.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T


class StructureMismatch(RuntimeError):
    """The checkpoint's leaves are not those of the tree restored into (not
    a corruption: `restore_latest_valid` does not delete it)."""


def _host_array(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """The array a leaf is stored as, and its dtype as the manifest names it."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(directory: str | Path, step: int, tree: Any, keep: int = 3) -> Path:
    """Write `tree` (tensor leaves) as checkpoint `step` of `directory`,
    atomically, then keep the newest `keep` checkpoints."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "leaves": {}}
    for i, (name, leaf) in enumerate(T.leaves_with_path(tree)):
        arr, dtype = _host_array(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(tmp / fn, arr)
        digest = hashlib.sha1((tmp / fn).read_bytes()).hexdigest()
        manifest["leaves"][name] = {
            "file": fn, "dtype": dtype, "shape": list(arr.shape), "sha1": digest,
        }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    dirfd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)

    # retention
    for old in [directory / f"step_{s:08d}" for s in retained_steps(directory)][:-keep]:
        shutil.rmtree(old)
    return final


def retained_steps(directory: str | Path) -> list:
    """Ascending step numbers of every retained (non-.tmp) checkpoint."""
    directory = Path(directory)
    if not directory.exists():
        return []
    return sorted(int(d.name.split("_")[1]) for d in directory.iterdir()
                  if d.is_dir() and d.name.startswith("step_")
                  and not d.name.endswith(".tmp"))


def latest_step(directory: str | Path) -> Optional[int]:
    steps = retained_steps(directory)
    return steps[-1] if steps else None


def _to_tensor(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
        raise StructureMismatch(f"leaf {tuple(t.shape)} {t.dtype} restored into "
                                f"{tuple(like.shape)} {like.dtype}")
    return t.to(like.device)


def restore(directory: str | Path, step: int, like: Any) -> Any:
    """Restore into the structure of `like`, each leaf on the device of
    `like`'s leaf.  Raises `IOError` on a SHA1 mismatch and
    `StructureMismatch` when the leaves' names, shapes or dtypes differ."""
    ck = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((ck / "manifest.json").read_text())
    named = list(T.leaves_with_path(like))
    if {n for n, _ in named} != set(manifest["leaves"]):
        raise StructureMismatch("checkpoint/model structure mismatch")
    out_leaves = []
    for name, leaf in named:
        meta = manifest["leaves"][name]
        # one read per leaf: hash and decode the same buffer
        raw = (ck / meta["file"]).read_bytes()
        if hashlib.sha1(raw).hexdigest() != meta["sha1"]:
            raise IOError(f"checkpoint corruption in {name}")
        arr = np.load(io.BytesIO(raw), allow_pickle=False)
        out_leaves.append(_to_tensor(arr, meta["dtype"], leaf))
    return T.unflatten(like, out_leaves)


def restore_latest_valid(directory: str | Path, like: Any) -> Optional[Tuple[Any, int]]:
    """Restore the newest retained checkpoint that verifies, walking back
    through older retained steps when the latest is corrupt or truncated
    (bad SHA1, missing manifest, undecodable leaf).  Bad checkpoint
    directories are deleted so retries and retention don't keep tripping on
    them.  Returns (state, step), or None when nothing restorable exists."""
    directory = Path(directory)
    for step in reversed(retained_steps(directory)):
        try:
            return restore(directory, step, like), step
        except (OSError, EOFError, ValueError) as e:
            # OSError covers the SHA1 IOError + missing files;
            # ValueError/EOFError cover truncated/undecodable npy payloads
            bad = directory / f"step_{step:08d}"
            print(f"[checkpoint] dropping corrupt {bad.name}: {e}")
            shutil.rmtree(bad, ignore_errors=True)
    return None
