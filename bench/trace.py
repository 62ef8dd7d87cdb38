"""The traced span: `torch.profiler` over whole iterations of the closed
loop, and what the per-layer metrics read from it.

  busy_s     the union of the device's operation intervals (kernels,
             copies, sets), so that nothing is counted twice
  window_s   the span's length on the host clock
  kernels    device seconds by operation name (`calls`: launches by name)
  ranges     device seconds of the operations that start inside each
             `record_function` range's device-side span (the model's
             `layers._span` ranges, e.g. `moe.experts`)
  breakdown  the ten operations that took most device time, and the ten
             host activities under which the device stood idle longest:
             each idle gap is charged to the innermost host operation
             running at its middle, prefixed by the innermost range
             around it
"""

from __future__ import annotations

import bisect
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

NAME_CHARS = 100


@dataclass
class SpanResult:
    busy_s: float
    window_s: float
    kernels: Dict[str, float]
    calls: Dict[str, int]
    ranges: Dict[str, float]
    breakdown: dict
    iterations: int = 0
    counted: Dict[str, int] = field(default_factory=dict)
    reckoned: Dict[str, List[tuple]] = field(default_factory=dict)

    def kernel_s(self, pattern: str) -> float:
        return sum(s for n, s in self.kernels.items() if pattern in n)

    def kernel_calls(self, pattern: str) -> int:
        return sum(c for n, c in self.calls.items() if pattern in n)

    def roofline(self, counter: str, kernel: str, bound) -> Optional[float]:
        """A kernel's share of its roofline (%): the sum of `bound` over the
        launches the span's calls need (`reckoned`), over the device time
        of the kernel's launches.  None unless the reckoned launches, the
        wrapper's counter and the kernel's launches in the trace agree."""
        shapes = self.reckoned.get(counter, [])
        traced = self.kernel_calls(kernel)
        if not (len(shapes) == self.counted.get(counter) == traced):
            print(f"{counter}: {len(shapes)} launches reckoned, {self.counted.get(counter)} "
                  f"counted, {traced} of {kernel} traced: no roofline", file=sys.stderr)
            return None
        t = self.kernel_s(kernel)
        if not shapes or t <= 0:
            return None
        return 100.0 * sum(bound(*s) for s in shapes) / t


def _is_device(e) -> bool:
    return str(e.device_type).endswith(("CUDA", "PrivateUse1"))


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_activity(cpu, mids, annotations):
    """For each gap middle (sorted), the innermost CPU event running then,
    prefixed by the innermost range around it.  `cpu` sorted by start."""
    names, stack, i = [], [], 0
    for m in mids:
        while i < len(cpu) and cpu[i].time_range.start <= m:
            e = cpu[i]
            while stack and stack[-1].time_range.end <= e.time_range.start:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1].time_range.end <= m:
            stack.pop()
        inner = stack[-1].name if stack else "host (no operation)"
        ann = next((e.name for e in reversed(stack[:-1]) if e.name in annotations), None)
        names.append(f"{ann} / {inner}" if ann else inner)
    return names


def analyse(prof, window_s: float, annotations) -> SpanResult:
    events = prof.events()
    ann = set(annotations) | {e.name for e in events if getattr(e, "is_user_annotation", False)
                              and not _is_device(e)}
    dev = [e for e in events if _is_device(e)]
    marks = [e for e in dev if e.name in ann or getattr(e, "is_user_annotation", False)]
    kern = sorted((e for e in dev if e.name not in ann
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)
    kernels: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for e in kern:
        kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
        calls[e.name] = calls.get(e.name, 0) + 1
    busy = _merge([(e.time_range.start, e.time_range.end) for e in kern])
    busy_s = sum(b - a for a, b in busy) / 1e6

    starts = [e.time_range.start for e in kern]
    ranges: Dict[str, float] = {}
    for m in marks:
        lo = bisect.bisect_left(starts, m.time_range.start)
        hi = bisect.bisect_left(starts, m.time_range.end)
        ranges[m.name] = ranges.get(m.name, 0.0) + sum(
            k.time_range.elapsed_us() for k in kern[lo:hi]) / 1e6

    cpu = [e for e in events if not _is_device(e)]
    if cpu:
        thread = max({e.thread for e in cpu}, key=lambda t: sum(e.thread == t for e in cpu))
        cpu = sorted((e for e in cpu if e.thread == thread), key=lambda e: e.time_range.start)
    gaps = []
    if cpu and busy:
        lo = min(cpu[0].time_range.start, busy[0][0])
        hi = max(max(e.time_range.end for e in cpu), busy[-1][1])
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle: Dict[str, float] = {}
    for (a, b), name in zip(gaps, _host_activity(cpu, [(a + b) / 2 for a, b in gaps], ann)):
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6

    def top(d):
        return [[n[:NAME_CHARS], s] for n, s in sorted(d.items(), key=lambda x: -x[1])[:10]]
    return SpanResult(busy_s=busy_s, window_s=window_s, kernels=kernels, calls=calls,
                      ranges=ranges,
                      breakdown={"device_ops": top(kernels), "idle_gaps": top(idle)})


class Span:
    """A profiler session opened and closed at iteration boundaries."""

    def __init__(self, annotations):
        self.annotations = annotations
        self.prof = None
        self.t0 = None
        self.result: Optional[SpanResult] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                         else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Close the session; the span's seconds on the host clock."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        return window_s
