"""One run of one cell: set-up, the window, the traced span, the check and
the result line.  Nothing here names a cell, a configuration or a metric:
each is found by its name in `BENCHMARK.json`.

  configs/<config>.json  the `ModelConfig` as it is run (its fields at the
                         top level), `expert_dtype`, `norm_eps`, the
                         reference and counts modules of its family (the
                         counts module also names the kernels it counts,
                         `KERNELS`), the deployment's batcher (`serve`),
                         and the source, the cuts and the deployment
  traffic/<mix>.json     the mix (`generator.Mix`); its `loop` names the
                         module of `loops/` that drives the batcher
  metrics/<metric>.py    `read(run)`: the metric's value, or None where it
                         finds nothing to read
  loops/, counts/, reference/   the modules the files above name, each
                         found by its name under the benchmark's root
  limits/<cell>.json     each compared number's limit and the readings it
                         was set from
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import torch

from bench import check, e2e, trace
from bench.generator import Mix

# top-level modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# the program's profiler ranges (`models/layers._span`) and the harness's own
RANGES = ("attention", "cross_attention", "encode", "moe.route", "moe.dispatch",
          "moe.experts", "moe.combine", "bench.admit")
# a traced span: whole iterations, at least this long on the host clock
SPAN_MIN_S, SPAN_MIN_ITERS = 2.0, 2
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, None: None}


@dataclass
class Cell:
    root: Path
    name: str
    workload: dict
    conf: dict
    mix: Mix
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, dict]

    def module(self, kind: str, name: str):
        return module(self.root, kind, name)

    def counts(self):
        return self.module("counts", self.conf["counts"])


def load(root: Path, name: str, spec: Optional[dict] = None) -> Cell:
    spec = spec or json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    conf = json.loads((root / cf["file"]).read_text())
    mix = Mix.load(root / "bench" / "traffic" / f"{wl['traffic']}.json", conf["serve"])
    e2e_m = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e_m}
    per = [m for m in spec["per_layer"]
           if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(root=root, name=name, workload=wl, conf=conf, mix=mix, end_to_end=e2e_m,
                per_layer=per, limits=check.load_limits(root, name))


def model_config(conf: dict):
    from repro_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in conf.items() if k in names})


_MODULES: Dict[Path, object] = {}


def module(root: Path, kind: str, name: str):
    """The module `bench/<kind>/<name>.py` under `root` (a metric's name
    holds dots, so it is loaded from its file), loaded once."""
    path = (root / "bench" / kind / f"{name}.py").resolve()
    if path not in _MODULES:
        key = f"bench_{kind}_{len(_MODULES)}"
        spec = importlib.util.spec_from_file_location(key, path)
        mod = sys.modules[key] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def read_metric(root: Path, name: str):
    return module(root, "metrics", name).read


@dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    loop: object                     # a `bench.loops` loop
    span: Optional[trace.SpanResult]

    @property
    def conf(self) -> dict:
        return self.cell.conf

    @property
    def counts(self):
        return self.cell.counts()

    @property
    def window_s(self) -> float:
        return self.loop.t_stop - self.loop.t_start

    def window_stats(self) -> dict:
        return self.loop.window_stats()

    def window_flops(self) -> Dict[str, float]:
        """Model FLOPs of the window's work: the real prompt tokens of every
        prefill and every decoded token (`counts.<family>`)."""
        c, k = self.conf, self.counts
        pre = sum(k.prefill_flops(c, len(s.prompt) - 1)
                  for s in admitted(self.loop, 2, self.loop.close_iter))
        dec = 0.0
        for s in self.loop.served:
            for j, it in enumerate(s.iters):
                if self.loop.in_window(it):
                    dec += k.decode_flops(c, len(s.prompt) - 1 + j)
        return {"prefill": pre, "decode": dec}


def admitted(loop, first: int, last: int):
    """The requests admitted in iterations first .. last (a request is
    admitted at the iteration after the one that submitted it)."""
    return [s for s in loop.served if first <= s.submit_iter + 1 <= last]


def kernels(cell: Cell) -> dict:
    """The program's kernel wrappers the cell's counts module names
    (`KERNELS`: name -> (module, attribute)), each with its `.launches`."""
    return {name: getattr(importlib.import_module(mod), attr)
            for name, (mod, attr) in cell.counts().KERNELS.items()}


def _span_after(loop, cell: Cell, holder: dict):
    """`after` for the loop: open the profiler at the first iteration past
    the window, close it on whole iterations once SPAN_MIN_S have passed,
    and stop the run."""
    kern = kernels(cell)

    def after(it: int) -> bool:
        if "span" not in holder:
            holder.update(span=trace.Span(RANGES), first=it,
                          launches={k: f.launches for k, f in kern.items()})
            holder["span"].start()
            return False
        sp = holder["span"]
        if it - holder["first"] < SPAN_MIN_ITERS or time.perf_counter() - sp.t0 < SPAN_MIN_S:
            return False
        window_s = sp.stop()
        res = trace.analyse(sp.prof, window_s, RANGES)
        res.iterations = it - holder["first"]
        res.counted = {k: f.launches - holder["launches"][k] for k, f in kern.items()}
        res.reckoned = reckon(cell, admitted(loop, holder["first"] + 1, it), res.iterations)
        holder["result"] = res
        return True
    return after


def reckon(cell: Cell, admitted, decode_steps: int) -> Dict[str, List[tuple]]:
    """The launches of the span's calls, by kernel, from the frozen dispatch
    counts."""
    k, c, mix = cell.counts(), cell.conf, cell.mix
    out: Dict[str, List[tuple]] = {name: [] for name in k.KERNELS}
    for s in admitted:
        for name, shapes in k.prefill_launches(c, mix.bucket_of(len(s.prompt))).items():
            out.setdefault(name, []).extend(shapes)
    for name, shapes in k.decode_launches(c, mix.n_slots).items():
        out.setdefault(name, []).extend(shapes * decode_steps)
    return out


def _admit_range(batcher) -> None:
    """Wrap this batcher's admissions in a `bench.admit` range (traced runs
    only), so that the breakdown tells admission from decoding."""
    admit = batcher._admit

    def traced(slot, req):
        with torch.profiler.record_function("bench.admit"):
            return admit(slot, req)
    batcher._admit = traced


def warm(cfg, params, mix: Mix, loop, device) -> int:
    """Prefill once each bucket the mix can take and the first wave (already
    submitted) does not: every shape the window will run is then warm."""
    from repro_torch.models import model as M

    used = {mix.bucket_of(len(s.prompt)) for s in loop.served}
    todo = [b for b in mix.buckets() if b not in used]
    for b in todo:
        toks = torch.ones((1, b), dtype=torch.long)
        M.prefill(cfg, params, {"tokens": toks}, cache_len=mix.max_len, device=device)
    return len(todo)


def loaded_forbidden() -> List[str]:
    """The top-level modules of FORBIDDEN this process holds (whole names:
    `repro_torch` is not `repro`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell: Cell, seed: int, seconds: float, traced: bool, t0: float,
            device="cuda", control: bool = False, log=print,
            clock=time.perf_counter) -> dict:
    """Run the cell; returns the result line's dict (`check` last).  `clock`
    stamps the tokens (the tests give a clock that ticks per call)."""
    from repro_torch.serve.engine import ContinuousBatcher
    from bench import weights

    dev = torch.device(device)
    marks = {"imports": clock()}
    torch.zeros(1, device=dev)
    marks["device"] = clock()
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.library()
    marks["kernels"] = clock()
    cfg = model_config(cell.conf)
    params = weights.draw(cfg, seed, dev, DTYPES[cell.conf.get("expert_dtype")])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    marks["weights"] = clock()
    mix = cell.mix
    batcher = ContinuousBatcher(cfg, params, n_slots=mix.n_slots, max_len=mix.max_len,
                                prompt_bucket=mix.prompt_bucket, device=dev)
    holder: dict = {}
    loop = cell.module("loops", mix.loop).make(
        batcher, mix, cfg.vocab, seed, seconds, clock=clock)
    if traced:
        loop.after = _span_after(loop, cell, holder)
    loop.fill()
    warmed = warm(cfg, params, mix, loop, dev)
    marks["warm"] = clock()
    if traced:
        _admit_range(batcher)
    loop.run_filled()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = loop.t_start - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    run = Run(cell=cell, loop=loop, span=holder.get("result"))
    served = [s for s in loop.served if any(loop.in_window(it) for it in s.iters)]
    failed = [s for s in served if len(s.tokens) != len(s.stamps) or len(s.stamps) > s.max_new
              or any(not 0 <= t < cfg.vocab for t in s.tokens)]
    counts = e2e.sample_counts(loop)
    log(f"samples: {counts['out_tok_s']} tokens, {counts['ttft_p90_ms']} first tokens, "
        f"{counts['tpot_p90_ms']} finished requests in {run.window_s:.3f} s "
        f"({loop.close_iter - 1} iterations)")
    w = loop.window_stats()
    log(f"window: {w['decode_iters']} decode steps of {w['decode_s'] / max(1, w['decode_iters']) * 1e3:.2f}"
        f" ms, {w['prefill_calls']} prefills of {w['prefill_s'] / max(1, w['prefill_calls']) * 1e3:.2f}"
        f" ms, {run.window_s - w['decode_s'] - w['prefill_s']:.3f} s besides")
    steps = list(marks.items()) + [("first wave", loop.t_start)]
    log(f"set-up {setup_s:.2f} s: " + ", ".join(
        f"{k} {b - a:.2f}" for (_, a), (k, b) in zip([("start", t0)] + steps[:-1], steps))
        + f" s; {warmed} buckets warmed")
    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = read_metric(cell.root, m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {**e2e.metrics(loop), "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if traced and run.span is not None:
        device_info.update(busy_s=run.span.busy_s, window_s=run.span.window_s)

    t_check = time.perf_counter()
    res = check.run(loop, mix, cell.conf, params, seed,
                    cell.module("reference", cell.conf["reference"]), control=control)
    judged = check.judge(res["readings"], cell.limits)
    correct = (not res["faults"] and not failed
               and all(v["value"] <= v["limit"] for v in judged.values()))
    log(f"readings: {json.dumps(res['readings'])}")
    log(f"check: {json.dumps(res['sample'])} in {time.perf_counter() - t_check:.1f} s"
        + (f"; faults: {res['faults']}" if res["faults"] else ""))
    if control:
        log("control: " + json.dumps(res["control"]))
    out = {"correct": bool(correct), "attempted": len(served), "failed": len(failed),
           "metrics": metrics, "device": device_info}
    if traced and run.span is not None:
        out["breakdown"] = run.span.breakdown
    out["check"] = judged
    return out
