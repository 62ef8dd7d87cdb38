"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` on the card: it draws the weights and the
traffic from the seed, serves the traffic through
`repro_torch.serve.engine.ContinuousBatcher` in a closed loop for the
window, checks what the window served against the plain reference in
`bench/reference/`, and prints one JSON line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name `BENCHMARK.json` gives:
`configs/<config>.json`, `traffic/<mix>.json`, `metrics/<metric>.py` and
`limits/<cell>.json`.  The yardstick (the generator, the reference, the
counts of operations and bytes, the peaks and the comparison) lives here
and imports nothing of `jax`, `repro` or `benchmarks`.
"""
