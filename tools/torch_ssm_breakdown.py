#!/usr/bin/env python3
"""Where `ssm_scan_kernel_ring`'s time goes at the batch-128 shapes of
`chip_smoke.SSM_PATH` (zamba2 and xlstm, both on the 4x16 bf16 variant).

    python3 tools/torch_ssm_breakdown.py > ssm_breakdown.log

Needs one NVIDIA Hopper GPU, `nvcc` and `cuobjdump`.  Builds
`src/repro_torch/csrc/ssm_scan.cu` twice into `build/ssm_breakdown/`:

  * as a cubin, whose SASS gives the instruction mix of one step of the
    4x16 bf16 variant's step loop (the innermost loop with the most f32
    instructions; the SASS is kept beside it as `ring.sass`);
  * as a library with `-DSSM_SCAN_CLOCKS`, whose ring kernel sums each
    warp's SM cycles by part of its tile loop (waiting for a tile's copies,
    the barrier, staging, storing outputs, the steps, the rest), for warp 0
    (which issues the bulk copies) and the other warps apart.

For each shape, one JSON line: the kernel's ms from the port's library and
from the instrumented one (what the counters cost), each part's cycles a
warp and share for both kinds of warp, the SM clock (cycles over
`globaltimer` ns), and the step loop's issue-slot use: its instructions
issued over 4 schedulers x 132 SMs x the kernel's cycles, beside the ms
its instructions, and its f32 instructions alone, would take at one issue
a cycle on every scheduler.  Then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (raises without a card)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402

OUT = Path(__file__).resolve().parents[1] / "build" / "ssm_breakdown"
SRC = _build.CSRC / "ssm_scan.cu"
RING_4x16_BF16 = "ssm_scan_kernel_ringILi4ELi16ELb1E"     # the mangled name's core
PARTS = ("wait", "sync", "stage", "store", "steps", "rest")   # csrc/ssm_scan.cu's CLK_*
N_CLOCKS = len(PARTS) + 2                                     # + warps, ns; for 2 kinds of warp
FP32 = {"FFMA", "FMUL", "FADD"}
SHAPES = [s for s in cs.SSM_PATH if s[0] in ("zamba2 B=128 L=128", "xlstm B=128 L=128")]


def _run(cmd) -> str:
    proc = subprocess.run([str(c) for c in cmd], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{cmd[0]} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> tuple:
    """(the instrumented library, the ring 4x16 bf16 kernel's ptxas lines
    in that build, the SASS of the plain build)."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    log = _run([nvcc, *_build.NVCC_FLAGS, "-DSSM_SCAN_CLOCKS", "-shared", SRC,
                "-o", OUT / "libssm_clocks.so"])
    ptxas, name = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            name = ln
        elif RING_4x16_BF16 in name and ("registers" in ln or "spill" in ln):
            ptxas.append(ln.strip())
    _run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin",
          SRC, "-o", OUT / "ring.cubin"])
    sass = _run([Path(nvcc).parent / "cuobjdump", "-sass", OUT / "ring.cubin"])
    (OUT / "ring.sass").write_text(sass)
    return ctypes.CDLL(str(OUT / "libssm_clocks.so")), ptxas, sass


def step_loop_mix(sass: str, rt: int = 4, ns: int = 16) -> dict:
    """Opcodes of one step of the ring kernel's step loop: the backward
    branch's body with the most f32 instructions in the 4x16 bf16 variant,
    divided by the steps it unrolls (rt*ns*3 + rt f32 instructions a step:
    a*S, + x*b, + S*c per entry, and each row's two partial sums added).
    Of the loops that hold at least one step's multiplies and fused
    multiply-adds, the shortest: the tile loop around it holds the same
    and more."""
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs if RING_4x16_BF16 in f.split("\n", 1)[0])
    ins, labels, pending = [], {}, []
    for ln in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", ln)      # branch targets, where printed as labels
        if lab:
            pending.append(lab.group(1))
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m:
            addr = int(m.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending = []
            text = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2).strip())
            ins.append((addr, text.split()[0].split(".")[0], text))
    loops = []
    for addr, op, text in ins:
        if op != "BRA":
            continue
        lab = re.search(r"(\.L_x_\d+)", text)
        hexa = re.search(r"0x([0-9a-f]+)", text)
        lo = labels.get(lab.group(1)) if lab else int(hexa.group(1), 16) if hexa else None
        if lo is not None and lo < addr:
            loops.append([o for a, o, _ in ins if lo <= a <= addr])
    per_step = 3 * rt * ns + rt
    loops = [ops for ops in loops
             if ops.count("FFMA") >= 2 * rt * ns and ops.count("FMUL") >= rt * ns]
    if not loops:
        raise RuntimeError("no loop with a step's f32 work in the ring kernel's SASS")
    loop = min(loops, key=len)
    n_fp = sum(o in FP32 for o in loop)
    unroll = max(1, round(n_fp / per_step))
    mix = Counter(loop)
    return {"instructions_a_step": len(loop) / unroll, "f32_a_step": n_fp / unroll,
            "steps_unrolled": unroll,
            "opcodes_a_step": {o: c / unroll for o, c in mix.most_common()}}


def measure(lib, shape, mix: dict, gen, reps: int = 5) -> dict:
    name, bh, l, p, n, dts, g = shape
    x, a, b, c = cs._ssm_inputs(gen, bh, l, p, n, dts, groups=g)
    plan = ss.ssm_plan(bh, g, l, p, n, dts)
    assert (plan.rt, plan.ns, plan.chunks) == (4, 16, 1), plan
    y = torch.empty((bh, l, p), dtype=torch.float32, device=cs.DEV)
    run = lambda: _build.check_launch(ss.launch(x, a, b, c, y, plan), "ssm_scan")  # noqa: E731
    ms = cs.time_ms(run)
    read = lib.ssm_scan_clocks
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    buf = (ctypes.c_ulonglong * (2 * N_CLOCKS))()
    with mock.patch.object(_build, "library", lambda: lib):
        ms_clocks = cs.time_ms(run)
        run()
        torch.cuda.synchronize()
        _build.check_launch(read(buf), "ssm_scan_clocks")       # back to zero
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        _build.check_launch(read(buf), "ssm_scan_clocks")
    want = cs._ssm_want(x, a, b, c)
    err = float((y - want).abs().max())
    by_warp, cycles_all, ns_all, warps_all = {}, 0, 0, 0
    for kind, row in (("warp 0", buf[:N_CLOCKS]), ("other warps", buf[N_CLOCKS:])):
        cycles = dict(zip(PARTS, row[:len(PARTS)]))
        warps, total = row[len(PARTS)], sum(cycles.values())
        if warps:
            by_warp[kind] = {"warps_a_call": warps // reps,
                             "cycles_a_warp": {k: v / warps for k, v in cycles.items()},
                             "share": {k: v / total for k, v in cycles.items()}}
        cycles_all, ns_all, warps_all = cycles_all + total, ns_all + row[len(PARTS) + 1], warps_all + warps
    ghz = cycles_all / ns_all
    blocks_an_sm = min(65536 // (128 * plan.threads), ss.SMEM_PER_SM // (plan.smem + 1024))
    at_one_issue = lambda instr: instr * l * (warps_all // reps) / (4 * ss.SMS * ghz * 1e6)  # noqa: E731
    step_ms = at_one_issue(mix["instructions_a_step"])
    return {"shape": name, "plan": plan.as_dict(), "ms": ms, "ms_with_clocks": ms_clocks,
            "max_abs_err_with_clocks": err, "sm_ghz": ghz,
            "warps_a_scheduler": blocks_an_sm * plan.threads / 32 / 4, "by_warp": by_warp,
            "step_loop_at_one_issue_a_cycle_ms": step_ms,
            "f32_alone_at_one_issue_a_cycle_ms": at_one_issue(mix["f32_a_step"]),
            "step_loop_issue_use_of_the_kernel": step_ms / ms,
            **cs.ssm_bound_ms(x, a, b, c)}


def main() -> None:
    info = cs.phase_device()
    lib, ptxas, sass = build()
    mix = step_loop_mix(sass)
    cs.emit({"ring_4x16_bf16_ptxas_with_clocks": ptxas, "step_loop": mix})
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    for shape in SHAPES:
        cs.emit(measure(lib, shape, mix, gen))
    print(info["nvidia_smi"], flush=True)


if __name__ == "__main__":
    main()
