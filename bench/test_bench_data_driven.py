"""A configuration, a mix, its loop, a counts module with a further kernel
and a per-layer metric are added by new files and new entries in
`BENCHMARK.json` alone: a throwaway cell in a copy of the benchmark, run on
the CPU, traced."""

import json
import shutil

from bench import harness, tiny


def test_a_new_cell_runs_from_new_files(tmp_path):
    shutil.copytree(tiny.ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    bench = tmp_path / "bench"

    conf = json.loads((bench / "configs/yi-6b.json").read_text())
    conf.update(tiny.WIDTHS, name="tiny-dense", counts="throwaway",
                serve={"n_slots": 4, "max_len": 176, "prompt_bucket": 16})
    (bench / "configs/tiny-dense.json").write_text(json.dumps(conf))
    # a loop of its own (here the closed loop's code under a new name)
    (bench / "loops/throwaway.py").write_text((bench / "loops/closed.py").read_text())
    mix = dict(json.loads((bench / "traffic/chat.json").read_text()),
               name="throwaway", loop="throwaway", block=8,
               prompt={"dist": "lognormal", "median": 20, "sigma": 0.3, "min": 8, "max": 60},
               output={"dist": "lognormal", "median": 5, "sigma": 0.3, "min": 2, "max": 9})
    (bench / "traffic/throwaway.json").write_text(json.dumps(mix))
    # counts of the family that also count a further kernel's launches
    (bench / "counts/throwaway.py").write_text(
        (bench / "counts/decoder.py").read_text()
        + '\nKERNELS = dict(KERNELS, ssm_scan=("repro_torch.kernels.ssm_scan", "ssm_scan"))\n')
    (bench / "metrics/throwaway.span_iters.py").write_text(
        '"""Iterations in the traced span."""\n\n\ndef read(run):\n'
        '    return float(run.span.iterations) if run.span else None\n')
    (bench / "metrics/throwaway.ssm_launches.py").write_text(
        '"""ssm_scan launches counted in the traced span."""\n\n\ndef read(run):\n'
        '    return float(run.span.counted["ssm_scan"]) if run.span else None\n')
    (bench / "limits/tiny.throwaway.json").write_text(
        json.dumps({"limits": {"gap": {"limit": 1.0}, "step_err": {"limit": 0.5}}}))
    spec["configs"].append({"name": "tiny-dense", "source": "https://huggingface.co/01-ai/Yi-6B",
                            "file": "bench/configs/tiny-dense.json", "reduced": [],
                            "why": "a throwaway"})
    spec["workloads"].append({"name": "tiny.throwaway", "config": "tiny-dense",
                              "traffic": "throwaway", "chips": 1, "why": "a throwaway"})
    for name in ("throwaway.span_iters", "throwaway.ssm_launches"):
        spec["per_layer"].append({"name": name, "unit": "count", "better": "higher",
                                  "source": "program_counter",
                                  "layer": "entry: serve/engine.py", "moves": "out_tok_s",
                                  "workloads": ["tiny.throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = {p: (tmp_path / p).read_bytes() for p in before}
    assert after == before                     # nothing that was there was edited

    cell = harness.load(tmp_path, "tiny.throwaway")
    assert cell.mix.loop == "throwaway" and cell.mix.n_slots == 4
    assert cell.module("loops", "throwaway").__file__.startswith(str(tmp_path))
    out = harness.execute(cell, 77, 0.1, True, 0.0, device="cpu", log=lambda s: None,
                          clock=tiny.ticks())
    m = out["metrics"]
    assert m["throwaway.span_iters"]["value"] >= harness.SPAN_MIN_ITERS
    assert m["throwaway.ssm_launches"]["value"] == 0      # a dense model runs no scan
    assert set(m) == {"throwaway.span_iters", "throwaway.ssm_launches"}  # the others list theirs
    assert list(out)[-1] == "check" and out["correct"]
    plain = harness.execute(cell, 77, 0.1, False, 0.0, device="cpu", log=lambda s: None,
                            clock=tiny.ticks())
    assert set(plain["metrics"]) == {"out_tok_s", "ttft_p90_ms", "tpot_p90_ms", "setup_s"}
