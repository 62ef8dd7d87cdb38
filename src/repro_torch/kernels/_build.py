"""Builds the CUDA sources under `repro_torch/csrc/` into one shared library
and loads it with `ctypes`.

The library is built at first use, from the sources in this checkout and
nothing else: one `nvcc -c` per `.cu` file, all started together, then one
link step.  The result lands in `build/repro_torch/` at the root of the
checkout (override with `REPRO_TORCH_BUILD_DIR`), keyed by a hash of the
sources and the flags, so an unchanged tree reuses it.  A failed build raises
with the compiler's output; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
build_seconds = 0.0          # wall time of the last build (0 when reused)
build_log = ""               # ptxas -v output of the last build


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("repro_torch: nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"repro_torch: no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(srcs, out: Path) -> None:
    global build_seconds, build_log
    t0 = time.perf_counter()
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = out.stem
    procs = []
    for src in srcs:
        obj = out.parent / f"{tag}_{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"repro_torch: nvcc failed for {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"repro_torch: link failed:\n{link.stdout}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library; built first if this tree's build is absent."""
    global _lib
    with _lock:
        if _lib is None:
            srcs = _sources()
            out = build_dir() / f"librepro_torch_{_digest(srcs)}.so"
            if not out.exists():
                _build(srcs, out)
            _lib = ctypes.CDLL(str(out))
        return _lib


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"repro_torch: {what} launch failed with CUDA error {err}")
