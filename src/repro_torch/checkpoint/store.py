"""Fault-tolerant checkpointing, in the reference's on-disk format.

  * step-atomic: write to `step_XXXXXXXX.tmp/`, fsync, rename: a crash
    mid-write never corrupts the latest checkpoint,
  * content-verified: a per-leaf SHA1 in `manifest.json`, checked on restore,
  * one `.npy` per leaf, named in the manifest by its `jax.tree_util.keystr`
    path (`repro_torch.tree`), so that an f32 checkpoint written by either
    package restores in the other,
  * retention: keep the newest `keep` checkpoints.

One writer serves one process and many (`save_sharded`; `save` is its
one-process case): the first process creates each leaf's `.npy` at its
full shape (the same bytes `np.save` writes), every process writes its
own slices into it (one positioned write for a slice that is one run of
the file, a memory map otherwise), and the first hashes the files, in
chunks and on threads, and writes the manifest.  One reader too:
`verify` checks the structure and the SHA1s, `read_slices` reads each
process's slices through a memory map (`restore` reads them whole), and
`latest_valid_step` walks back past corrupt checkpoints (for a sharded
trainer on one rank, the others taking its answer: `runtime.trainer`).  So a
checkpoint written by any number of ranks restores at any other, one
device included, and no process holds a whole leaf to write or read it.

A bf16 leaf has no numpy dtype here: its bits are stored as a uint16 array,
with "bfloat16" as its dtype in the manifest.  Restore reads such a leaf
from these files and from the reference's, which numpy loads as 2-byte
void records.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import math
import os
import shutil
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as T


class StructureMismatch(RuntimeError):
    """The checkpoint's leaves are not those of the tree restored into (not
    a corruption: `restore_latest_valid` does not delete it)."""


# how much of a file `_sha1` reads at a time
_HASH_CHUNK = 1 << 24


def _sha1(path: Path) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(_HASH_CHUNK), b""):
            h.update(block)
    return h.hexdigest()


def _sha1_all(paths) -> List[str]:
    """Each file's SHA1, the files hashed on threads (`hashlib` releases
    the interpreter lock while it hashes a large block)."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(_sha1, paths))


def _run_start(shape, index) -> Optional[int]:
    """The element offset of the block `index` (one slice per dimension)
    of a C-ordered array of `shape` when the block is one contiguous run,
    else None: the dimensions before its first cut have length 1 and those
    after it are whole."""
    cut = [i for i, (n, sl) in enumerate(zip(shape, index)) if sl.indices(n)[:2] != (0, n)]
    if not cut:
        return 0
    d = cut[0]
    if cut[1:] or any(n != 1 for n in shape[:d]):
        return None
    return index[d].indices(shape[d])[0] * math.prod(shape[d + 1:])


def _write_piece(path: Path, index: tuple, arr: np.ndarray) -> None:
    """`arr` into the block `index` of the `.npy` file at `path`."""
    if arr.size == 0:
        return
    mm = np.load(path, mmap_mode="r+")
    start = _run_start(mm.shape, index)
    if start is None:
        mm[index] = arr
        mm.flush()
        return
    offset = mm.offset + start * mm.dtype.itemsize
    del mm
    view = memoryview(np.ascontiguousarray(arr)).cast("B")
    fd = os.open(path, os.O_WRONLY)
    try:
        while view:                      # a write may stop short of a large buffer
            n = os.pwrite(fd, view, offset)
            view, offset = view[n:], offset + n
    finally:
        os.close(fd)


def _host_array(leaf: torch.Tensor) -> np.ndarray:
    """The array a leaf is stored as (a bf16 leaf's bits as uint16)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _fresh_tmp(directory: Path, step: int) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    return tmp


def _publish(directory: Path, step: int, tmp: Path, manifest: dict, keep: int) -> None:
    """Write the manifest, fsync, rename the `.tmp` directory into place,
    then keep the newest `keep` checkpoints."""
    final = directory / f"step_{step:08d}"
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


# a leaf of a sharded save: (its path name, its full shape, its dtype, and
# a function giving the (index, tensor) slices this process writes of it)
ShardedLeaf = Tuple[str, Sequence[int], torch.dtype, Callable[[], List[Tuple[tuple, torch.Tensor]]]]


def _file_dtype(dtype: torch.dtype) -> Tuple[np.dtype, str]:
    """The numpy dtype a leaf of `dtype` is stored as, and the manifest's name."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16), "bfloat16"
    d = torch.empty((), dtype=dtype).numpy().dtype
    return d, str(d)


def save_sharded(directory: str | Path, step: int, leaves: Sequence[ShardedLeaf], keep: int = 3,
                 *, first: bool, barrier: Callable[[], None]) -> None:
    """Checkpoint `step` of `directory` written by one or several
    processes, each calling this with the same leaves and `barrier` (which
    returns when all have reached it).  The `first` process creates the
    `.tmp` directory and each leaf's file at its full shape; every process
    writes the slices its leaves' functions give through a memory map; the
    first hashes the files (`_sha1_all`) and publishes the checkpoint."""
    directory = Path(directory)
    tmp = directory / f"step_{step:08d}.tmp"
    if first:
        _fresh_tmp(directory, step)
        for i, (_, shape, dtype, _) in enumerate(leaves):
            np.lib.format.open_memmap(tmp / f"leaf_{i:05d}.npy", mode="w+",
                                      dtype=_file_dtype(dtype)[0], shape=tuple(shape)).flush()
    barrier()
    for i, (_, _, _, pieces) in enumerate(leaves):
        for index, t in pieces():
            _write_piece(tmp / f"leaf_{i:05d}.npy", index, _host_array(t))
    barrier()
    if first:
        files = [f"leaf_{i:05d}.npy" for i in range(len(leaves))]
        manifest = {"step": step, "leaves": {}}
        for fn, (name, shape, dtype, _), digest in zip(files, leaves,
                                                       _sha1_all(tmp / fn for fn in files)):
            manifest["leaves"][name] = {"file": fn, "dtype": _file_dtype(dtype)[1],
                                        "shape": list(shape), "sha1": digest}
        _publish(directory, step, tmp, manifest, keep)
    barrier()


def save(directory: str | Path, step: int, tree: Any, keep: int = 3) -> Path:
    """Write `tree` (tensor leaves) as checkpoint `step` of `directory`,
    atomically, then keep the newest `keep` checkpoints: `save_sharded`
    with one process writing every leaf whole."""
    leaves = [(name, tuple(leaf.shape), leaf.dtype, lambda leaf=leaf: [((), leaf)])
              for name, leaf in T.leaves_with_path(tree)]
    save_sharded(directory, step, leaves, keep, first=True, barrier=lambda: None)
    return Path(directory) / f"step_{step:08d}"


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


def _whole(like: Any) -> Any:
    """`read_slices`'s leaves for reading each leaf of `like` whole."""
    return T.map_structure(lambda t: SimpleNamespace(index=(), shape=tuple(t.shape),
                                                     dtype=t.dtype, device=t.device), like)


def restore(directory: str | Path, step: int, like: Any) -> Any:
    """Restore into the structure of `like`, each leaf on the device of
    `like`'s leaf: `verify`, then `read_slices` of every leaf whole.
    Raises `IOError` on a SHA1 mismatch and `StructureMismatch` when the
    leaves' names, shapes or dtypes differ."""
    verify(directory, step, like)
    return read_slices(directory, step, _whole(like))


def verify(directory: str | Path, step: int, like: Any) -> None:
    """Check checkpoint `step` against the full shapes and dtypes of
    `like`'s leaves (anything with `.shape` and `.dtype`) and each file's
    SHA1 (`_sha1_all`).  Raises `IOError` on a SHA1 mismatch or a missing
    file and `StructureMismatch` when the leaves' names, shapes or dtypes
    differ."""
    ck = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((ck / "manifest.json").read_text())
    named = list(T.leaves_with_path(like))
    if {n for n, _ in named} != set(manifest["leaves"]):
        raise StructureMismatch("checkpoint/model structure mismatch")
    for name, leaf in named:
        meta = manifest["leaves"][name]
        if (tuple(meta["shape"]) != tuple(leaf.shape)
                or meta["dtype"] != _file_dtype(leaf.dtype)[1]):
            raise StructureMismatch(f"{name}: {meta['shape']} {meta['dtype']} restored into "
                                    f"{tuple(leaf.shape)} {leaf.dtype}")
    digests = _sha1_all(ck / manifest["leaves"][name]["file"] for name, _ in named)
    for (name, _), digest in zip(named, digests):
        if digest != manifest["leaves"][name]["sha1"]:
            raise IOError(f"checkpoint corruption in {name}")


def read_slices(directory: str | Path, step: int, like: Any) -> Any:
    """Checkpoint `step` read slice by slice, unchecked (`restore` and the
    sharded trainer call `verify` first): for each leaf of `like` (with
    `.index`, and the slice's `.shape`, the leaf's `.dtype` and the
    `.device` it goes to), the slice `index` of the stored leaf, read
    through a memory map."""
    ck = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((ck / "manifest.json").read_text())
    out = []
    for name, leaf in T.leaves_with_path(like):
        meta = manifest["leaves"][name]
        arr = np.load(ck / meta["file"], mmap_mode="r", allow_pickle=False)
        # a copy: the map is read-only, and the state is updated in place
        out.append(_to_tensor(np.array(arr[leaf.index]), meta["dtype"], leaf))
        del arr
    return T.unflatten(like, out)


def check(directory: str | Path, step: int, like: Any) -> bool:
    """Whether checkpoint `step` verifies against `like` (`verify`); a
    corrupt or truncated one (bad SHA1, missing manifest or file,
    undecodable manifest) is deleted, so that retries and retention don't
    keep tripping on it.  `StructureMismatch` and anything else raise."""
    try:
        verify(directory, step, like)
        return True
    except (OSError, EOFError, ValueError) as e:
        # OSError covers the SHA1 IOError + missing files
        bad = Path(directory) / f"step_{step:08d}"
        print(f"[checkpoint] dropping corrupt {bad.name}: {e}")
        shutil.rmtree(bad, ignore_errors=True)
        return False


def latest_valid_step(directory: str | Path, like: Any) -> Optional[int]:
    """The newest retained step of `directory` that verifies against
    `like`, walking back through older retained steps past corrupt ones
    (`check` deletes them), or None.  A sharded trainer has one rank call
    this and the others take its answer (`runtime.trainer.Trainer`)."""
    for step in reversed(retained_steps(directory)):
        if check(directory, step, like):
            return step
    return None


def restore_latest_valid(directory: str | Path, like: Any) -> Optional[Tuple[Any, int]]:
    """Restore the newest retained checkpoint that verifies
    (`latest_valid_step`).  Returns (state, step), or None when nothing
    restorable exists."""
    step = latest_valid_step(directory, like)
    if step is None:
        return None
    return read_slices(directory, step, _whole(like)), step
