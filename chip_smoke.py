#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py                  # everything, as the acceptance check runs it
    python3 chip_smoke.py --only kernels   # stop after the kernel comparisons
    python3 chip_smoke.py --only photonic_mac   # stop after photonic_mac's comparisons
    python3 chip_smoke.py --only flash_attention   # stop after flash_attention's
    python3 chip_smoke.py --only ssm_scan  # stop after ssm_scan's
    python3 chip_smoke.py --only engine    # the engine phases alone (no kernel build)
    python3 chip_smoke.py --only mesh_serve  # serving under a mesh alone
    python3 chip_smoke.py --only dryrun    # the dry-run cells alone (no kernel build)
    python3 chip_smoke.py --profile        # also: device time by kernel per model

Needs one NVIDIA Hopper GPU, `nvcc` and PyTorch built for CUDA; it raises
(non-zero exit, no result line) without a card.  It builds the CUDA kernels
from `src/repro_torch/csrc/`, then runs these phases, each printing one JSON
line, and fails if any phase fails:

  device            card name and power limit, versions, build seconds
  kernels           `photonic_mac`, `flash_attention` and `ssm_scan` against
                    their plain PyTorch versions on the card, at the shapes of
                    the reference's kernel tests, at ragged and edge shapes,
                    and at the serving shapes of the ten models below, with
                    times, a library call's time as yardstick where one
                    PyTorch call computes the same function, and the card's
                    bound for the same work; `photonic_mac` also on the
                    tensor-parallel split's padded column shards of a
                    yi-6b `ffn` weight (`MAC_SHARD`), against the global
                    product's columns

then the analytic engine (`src/repro_torch/core/`: topologies, laser and
trimming, latency and energy, the CrossLight accelerator, the design-space
sweep and the fault layer) in float64 on the card, each phase held against
the port's own CPU evaluation (continuous values at rtol 1e-12, discrete
fields such as stage, bank and router counts exactly):

  engine_fig4  paper Fig. 4 (`benchmarks/torch_fig4_trine.py`): its five
               checks (TRINE's best latency and energy, its laser and
               trimming power above SPACX's and Tree's, 2 and 5 stages and
               K* = 8) True; every row, and the network columns of all five
               topologies over a 180-row grid, equal to the CPU's
  engine_fig6  paper Fig. 6 (`benchmarks/torch_fig6_crosslight.py`): the
               three CrossLight variants x six CNNs, its checks True, the
               four averages beside the paper's, equal to the CPU's
  engine_sweep `benchmarks/torch_sweep_bench.py`'s 4096-config grid: its
               checks (batched within 1e-4 of the scalar dataclass loop,
               >= 20x its configs/s), the card equal to the CPU, and
               `sweep_chunked(MinReducer)` bit-identical to the monolithic
               argmin for materialize host/device x prefetch 0/1/2 x chunk
               n/8 and 1000; configs/s of the three
  engine_stream  9,830,400 configurations x six CNN traffics streamed in
               chunks of 2^20 through `MinReducer("energy_j")`: device
               materialization at prefetch 2 and 0 and host materialization
               at prefetch 0 bit-identical (minima, indices and 4096 sampled
               rows, drawn from `--seed`); those rows and the six winners
               equal to the CPU's; seconds, configs/s, peak device memory
  engine_availability  `availability_search` over 51,200 configurations
               under 256 fault scenarios (`--seed`): bit-identical across
               materialize and prefetch 0/2, a faulted run under HEALTHY
               bitwise the plain sweep, the yields of a 2048-row window
               equal to the CPU's
  engine_fabric  the fabric layer: the six presets and `Fabric.from_config`
               on three of the stream's rows (`--seed`) degraded under
               `resilience_bench`'s expected scenarios at severities 0.25,
               0.5, 1.0 on the card, equal to the CPU's; then
               `benchmarks/torch_resilience_bench.py` in full mode (102,400
               configurations x 16 scenarios in its yield grid), every check
               True, its curves equal to the CPU's
  engine_pareto  the search: `pareto_mask` on clouds from `--seed` (m = 2,
               3; 1 to 65,536 points; ties, duplicates, fronts of half the
               cloud) against the definition on the CPU; then
               `benchmarks/torch_pareto_bench.py` in full mode (its
               exactness checks required, its timing bars reported): the
               1,105,920-point co-design front verified exactly against the
               card's own cloud, the streamed network and co-design fronts
               bit-identical over materialize host/device x prefetch 0/2,
               the front's points equal to the CPU's evaluation of the same
               indices, the smoke grid's card and CPU fronts compared (a
               differing index set is printed with its rows' gaps), and
               `fabrics_from_front` on the front; the bench's refine
               sections run there too.  The bench's timed chunked path
               runs each chunk of the 138,240-network grid as one CUDA
               graph (`core.accelerator.CodesignChunk`), every chunk held
               bit for bit against the eager evaluation of its rows; the
               chunked-over-monolithic ratio is reported beside its bar
               (1.5), not required
  engine_refine  the refinement engines: the bench's refine checks (the
               refined front weakly dominating its seeds and improving one,
               the trust-region front dominating the first-order one, its
               designs re-scoring bit for bit) True; `refine_front_point`
               (48 steps), `refine_front` first order (top 3 seeds of the
               full co-design front x 32 steps) and trust region (the same
               seeds x 32 steps against a 3-CNN batch) on the card and on
               the CPU: seconds and steps a second of each, launches of one
               value-and-gradient call and one Hessian, the Hessian's share
               of a trust-region step; integer designs, candidate counts,
               accept/reject and line-search counts equal, traces, relaxed
               values and sensitivities at rtol 1e-9 (a differing design is
               printed with its exact scores on both devices and must tie);
               then `examples/torch_photonic_design_space.py` in smoke mode
  engine_whatif  the benchmarks that price LM steps over photonic fabrics:
               `benchmarks/torch_fabric_whatif.py` in full mode (its
               co-design frontier searched on the card; every check True;
               the ranking, every cell's bottleneck under every fabric and
               every results row equal to the CPU run's), then
               `torch_roofline.py` (its photonic roofline on the card)
               equal to the CPU's, seconds of each on both; and
               `torch_collectives_bench.py` (host arithmetic: it runs on
               no device) and its seconds

then the serving paths at full published width (bf16, photonic numerics,
kernels on, random weights from a seed), one model at a time, at published
depth except the six larger models, each cut to the deepest stack that
leaves 4 GB of the card free at its batch-128 prefill's peak (`DEPTH`):

  yi-6b        serve_continuous (ContinuousBatcher, bucketed prefill),
               serve_fabric (the same requests through a batcher modelling
               the trine_siph fabric, a fault injected at decode iteration
               3: the same tokens, the CPU's channel plans and modelled
               network seconds) and serve_batch128 (`launch/serve.py`,
               batch 128 x prompt 128)
  zamba2-1.2b  serve_continuous (exact-length prefill of 24..1024 tokens),
               serve_batch128, and long_prefill (B=1, 4096 tokens: the shared
               attention's whole window, 32 scan chunks in sequence)
  xlstm-350m   serve_batch128
  mixtral-8x7b 24 of its 32 layers (the experts, stored in bf16, are 2.82 GB
               a layer: 24 is the deepest the card holds with room for the
               batch-128 transients); serve_continuous and serve_batch128 as
               yi-6b, and long_prefill (B=1, 4224 tokens, past the 4096
               window, so the attention kernel's window masks keys that
               causality keeps, and the decode step after it rolls the
               windowed cache)
  seamless-m4t-medium  12 encoder + 12 decoder layers; serve_batch128 against
               the launcher's 32 encoder frames, and long_encoder (B=1, a
               128-token prompt against 1024 frames, then one decode step);
               the batcher refuses encoder-decoder configs, as the
               reference's cannot serve them
  qwen2-vl-72b 18 of its 80 layers (3.51 GB a layer in f32; 73.2 GB of
               weights); serve_continuous and serve_batch128 as yi-6b, with
               M-RoPE positions (per-slot (3, B, 1) in the batcher's decode)
  yi-34b       32 of 60 layers, deepseek-67b 24 of 95, gemma3-27b 40 of 62
               (its head the tied embedding, 262144 wide), each as yi-6b
  grok-1-314b  6 of 64 layers (bf16 experts, 9.66 GB a layer, d_ff 32768);
               serve_continuous and serve_batch128 as yi-6b (no window)

and the training path (`train`): zamba2-1.2b at published width and depth
(bf16 compute, f32 masters and AdamW moments, photonic numerics, kernels on,
`remat="full"`) trained 8 steps through `launch/train.py` on `SyntheticLM`
batches of 8 x 2048 tokens, checkpointing every 2 steps into a temporary
directory, modelling the trine_siph fabric with a fault injected before
step 3 (the channel plan and exposed network seconds equal to the CPU's);
a fresh trainer without a fabric resumed from a step-2 checkpoint must
reach the straight run's step-4 state bit for bit, the loss must be finite and fall,
and one f32 step at B=2 x 2048 with the kernels and with their plain
versions must agree in loss and gradient norm (`TRAIN_TOLERANCE`).
Then `train_wire`: the same model and flags trained 8 steps of 8 x 2048
tokens through `make_train_step(param_wire=)` under the 8-bit parameter
wire (`parallel/wire.py`: layer stacks as int8 pairs dequantized in each
layer body, the other weights quantized in place, gradients straight
through to the f32 masters): the loss finite and falling, every step's
gradient norm within a factor of `WIRE_GRAD_NORM_FACTOR` of the straight
run's at the same step, the launches
those of `train_step_launches` (the wire launches no kernel), step
seconds, tokens/s and peak memory beside `train`'s, and the pairs'
payload; then, at the reference wire tests' setting (reduced yi-6b, B=2 x
64, seed 0), the wire's master gradients within 0.05 (16 bits) and 0.25 (8
bits) of the masters', one f32 step under the wire with the kernels
against the port's plain CPU step (`TRAIN_TOLERANCE`), and
`launch/train.py --wire-bits 8` training bit for bit as without the flag.

Then `mesh`, the cross-device layer (`launch/mesh.py`,
`parallel/collectives.py`, `parallel/pipeline.py`, `parallel/sharding.py`,
the sharded step of `runtime/trainer.py`) through NCCL at world size 1 on a
file-store rendezvous, `make_test_mesh(1, 1, 1)` on the card: the flat,
TRINE and compressed all-reduces on one f32 vector of zamba2-1.2b's
gradient length (`cfg.param_count()` elements; flat and TRINE equal to
their input exactly, the compressed one's output plus new residual equal
to input plus incoming residual within f32 rounding and its error within
the reference test's 8 max|x| / 127, for one scale and 64-element chunks,
the int8 levels and scales of a 2^24-element slice equal to the CPU's),
`pipelined_apply` at S = 1 forward and backward against
`sequential_reference`, and zamba2-1.2b at full size trained `MESH_STEPS`
steps of 8 x 2048 through `Trainer(mesh=)` (a state drawn shard by shard,
each layer's weights gathered at its use and its gradient reduced into
the rank's shard, a checkpoint written by the rank's slices at the end)
against the first steps of `train`'s straight run, a `Trainer(mesh=None)`:
losses and gradient norms within `MESH_TOLERANCE`, its launches per step,
step seconds and peak memory beside the card.  Then mixtral-8x7b at
published width and `MESH_MOE_DEPTH` layers, `MESH_STEPS` steps of
`MESH_MOE_BATCH` through `Trainer(mesh=)` against the one-device step on
the same state and batches, the same checks (its own path of launches,
`mixtral-8x7b train_mesh`).  Then zamba2-1.2b once more through
`Trainer(mesh=)` under the 8-bit wire (`cfg.wire_bits`: the per-layer
gathers move int8 levels, `zamba2-1.2b train_mesh_wire`) against the first
`MESH_STEPS` steps of `train_wire`, the same checks.  NCCL takes no two
ranks on one card: the phase proves the path builds and launches, not
that it splits work or memory; the `model` axis has size 1, where the
tensor-parallel split is the identity.

Then `mesh_serve`: serving under a mesh (`serve/sharded.py`) through NCCL
at world size 1: yi-6b at published width and 8 of its 32 layers, and
zamba2-1.2b as published, each a batch-128 x 128 sharded prefill and 8
sharded decode steps on the rank's shards and cache (the reference's
layouts) against the one-device `prefill` and `serve_step` with kernels
on: logits and cache bit for bit, launches equal (its own path, `<model>
mesh_serve`), tokens/s and peaks of both.  Then `dryrun`: `python -m
repro_torch.launch.dryrun` on yi-6b train_4k single, mixtral-8x7b
prefill_32k multi and zamba2-1.2b long_500k single, three processes at
once, each one rank of the production mesh over a fake process group on
the host: each cell's bottleneck, three roofline terms and argument GiB a
device, counts priced on the modelled TPU-class fabric, not times of the
card.

Last, `examples`: the five model examples (`examples/torch_quickstart.py`,
`torch_continuous_batching.py`, `torch_serve_batched.py`, which runs the
serving launcher in its own process, `torch_photonic_mac_ablation.py` and
`torch_train_e2e.py` with LM_100M for 60 steps and a failure injected at
step 30) and `benchmarks/torch_kernels_bench.py`, each `main` on the card,
with the reference smoke tests' checks and their seconds.

Before each path the launch counters are set to 0; just after it they are
read and must equal the counts reckoned from the dispatch predicates in
`kernels/ops.py` (for training, straight, under the wire and under the
mesh: the forward,
and its recomputation under remat in the backward, which is plain), and
every kernel of that path must have launched.  After each serving path, `end_to_end` holds kernels-on
against kernels-off logits of one prefill (in f32 for zamba2, xlstm,
mixtral and grok-1, whose routing or recurrence amplifies bf16 rounding;
`E2E_TOLERANCE`; seamless against 32 frames;
qwen2-vl every position's logits through `train_logits`, with 64 pixel
embeddings and distinct M-RoPE streams).  For mixtral and grok-1 it also counts the
expert choices that differ between the two bf16 runs and holds the bf16
logits with the plain run's choices; mixtral runs once more in f32 at 4224
tokens, past the window (16 layers: `E2E_LONG`), where the plain version
with the window off must fail the tolerance; gemma3-27b as published, 5:1
local:global (12 layers), in bf16 at 2048 tokens, past its 1024 window,
likewise.  yi-34b, deepseek-67b and gemma3-27b (both builds), checked in
bf16, are held in f32 too (`E2E_F32_WITNESS`).  The last lines are the
`{"kernels": [...]}` summary, the card's name and power limit, and
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import gc
import json
import math
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs one GPU")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs as C  # noqa: E402
from repro_torch import core as EC  # noqa: E402
from repro_torch.core import faults as EF  # noqa: E402
from repro_torch.core import search as ESR  # noqa: E402
from repro_torch.core.accelerator import CodesignChunk  # noqa: E402
from repro_torch.core import sweep as ES  # noqa: E402
from repro_torch.core.xp import TorchNS  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.photonic_mac import (  # noqa: E402
    BANK, bank_absmax, dispatch, mac_plan, mac_ranges, mac_splits, photonic_mac,
    quantize_weights)
from repro_torch.kernels import ssm_scan as SS  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import collectives as CC  # noqa: E402
from repro_torch.parallel import pipeline as PP  # noqa: E402
from repro_torch.parallel import wire as W  # noqa: E402
from repro_torch.runtime import trainer as TR  # noqa: E402
from repro_torch.serve import sharded as SV  # noqa: E402
from repro_torch.serve.engine import ContinuousBatcher  # noqa: E402
# the card's peaks, a photonic_mac product's bound, the kernel timer, the card
from repro_torch.kernels.timing import (  # noqa: E402
    HBM_BYTES_PER_S, PEAK_FLOPS, card, mac_bound_ms, time_ms)

DEV = torch.device("cuda")
SEED = 0

# yi-6b's linears as (K, N): wq/wo, wk/wv, wg/wi, mlp wo, lm_head
YI_KN = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096), (4096, 64000)]
# the tiled linears of zamba2 (out_proj, shared attention, head) and of xlstm
# (wqkv, wo, sLSTM wx, tied head); in_proj (N = 8384) and wif (N = 8) never tile
ZAMBA2_KN = [(4096, 2048), (2048, 2048), (2048, 32000)]
XLSTM_KN = [(1024, 3072), (1024, 1024), (1024, 4096), (1024, 50304)]
# mixtral's wk/wv and head (wq/wo are yi-6b's 4096 x 4096); its experts are
# plain products and its router (N = 8) never tiles
MIXTRAL_KN = [(4096, 1024), (4096, 32000)]
# seamless's mlp wo (its wq/wk/wv/wo (1024, 1024) and wg/wi (1024, 4096) are
# xlstm's; its head, N = 256206, never tiles)
SEAMLESS_KN = [(4096, 1024)]
# qwen2-vl's wq/wo, wk/wv, wg/wi, mlp wo, lm_head
QWEN_KN = [(8192, 8192), (8192, 1024), (8192, 29568), (29568, 8192), (8192, 152064)]
# yi-34b's wq/wo, wk/wv, wg/wi, mlp wo
YI34_KN = [(7168, 7168), (7168, 1024), (7168, 20480), (20480, 7168)]
# deepseek-67b's wg/wi and mlp wo (its wq/wo and wk/wv are qwen2-vl's,
# timed under that name)
DEEPSEEK_KN = [(8192, 22016), (22016, 8192)]
# the heads of yi-34b, deepseek-67b, grok-1 and gemma3-27b (its tied
# embed.t(), 2048 column tiles); a prefill takes the head on its last
# position only, so M is the batch: 128 in a batch-128 decode step and the
# batch-128 prefill, 1 in a B=1 prefill (the end-to-end check)
NEW_HEADS = [("yi-34b head", 7168, 64000), ("deepseek-67b head", 8192, 102400),
             ("grok-1-314b head", 6144, 131072), ("gemma3-27b head", 5376, 262144)]
# gemma3-27b's wq, wk/wv, wo (32 heads of 128 make 4096, not 5376), wg/wi,
# mlp wo
GEMMA3_KN = [(5376, 4096), (5376, 2048), (4096, 5376), (5376, 21504), (21504, 5376)]
# grok-1's wq/wo and wk/wv (its experts are plain products, its router
# never tiles)
GROK_KN = [(6144, 6144), (6144, 1024)]
# the timed products (model, M, K, N), bf16 activations as on the path: M = 128
# is a batch-128 decode step, 512 a B=1 prefill of 512 tokens, 16384 the
# batch-128 x 128 prefill (its widest linear, and every (K, N) whose K is
# split, which there is summed in turn by each block)
MAC_TIMED = ([("yi-6b", m, k, n) for m in (128, 512) for (k, n) in YI_KN]
             + [("yi-6b", 128 * 128, 4096, 11008)]
             + [("zamba2-1.2b", 128, k, n) for (k, n) in ZAMBA2_KN]
             + [("xlstm-350m", 128, k, n) for (k, n) in XLSTM_KN]
             + [(model, 128 * 128, k, n)
                for model, kns in (("yi-6b", YI_KN), ("zamba2-1.2b", ZAMBA2_KN),
                                   ("xlstm-350m", XLSTM_KN))
                for (k, n) in kns if mac_splits(k, n) > 1]
             + [("mixtral-8x7b", m, k, n) for m in (128, 128 * 128) for (k, n) in MIXTRAL_KN]
             + [("seamless-m4t-medium", m, k, n) for m in (128, 128 * 128)
                for (k, n) in SEAMLESS_KN]
             + [("qwen2-vl-72b", m, k, n) for m in (128, 128 * 128) for (k, n) in QWEN_KN]
             + [(model, m, k, n) for model, kns in (("yi-34b", YI34_KN),
                                                    ("deepseek-67b", DEEPSEEK_KN),
                                                    ("gemma3-27b", GEMMA3_KN),
                                                    ("grok-1-314b", GROK_KN))
                for m in (128, 128 * 128) for (k, n) in kns]
             + [(model, m, k, n) for (model, k, n) in NEW_HEADS for m in (1, 128)]
             # the training path's tiled linears (zamba2 at B=8 x 2048: out_proj
             # and the shared attention's projections at 16384 rows, the head
             # once per 1024-token CE chunk, 8192 rows)
             + [("zamba2-1.2b train", m, k, n)
                for (m, k, n) in ((16384, 4096, 2048), (16384, 2048, 2048), (8192, 2048, 32000))])
# the plain version of a timed product whose output holds more than this
# many elements is compared on its first `MAC_PLAIN_ROWS` rows only
MAC_PLAIN_ELEMS, MAC_PLAIN_ROWS = 16384 * 32000, 1024
MAC_HEADLINE = (128, 4096, 11008)        # the shape reported in the summary line
# the tensor-parallel split's padded shards (`ops.shard_banks`): (M, K, N,
# ranks) and the ranks checked: columns 688 r .. 688 (r + 1) of yi-6b's
# 11008-wide `ffn` weight as model 16 cuts it, each straddling bank edges
MAC_SHARD = (128, 4096, 11008, 16)
MAC_SHARD_RANKS = (1, 2)
# the timed attention prefills (model, B, Sq, Sk, Hq, Hk, D, causal,
# window): strided (B,S,H,D) projections, bf16; yi-6b (32/4 heads of 128)
# and zamba2's shared attention (32/32 heads of 64, window 4096, which at
# S <= 4096 masks nothing that causality keeps) and mixtral (32/8 heads of
# 128, window 4096, which at S = 4224 does) and qwen2-vl (64/8 heads of
# 128), causal; seamless (16/16 heads of 64) with no mask: its encoder over
# 1024 frames, and its decoder's cross-attention, 128 queries against 32
# frames (the batch-128 path) and against 1024 (the long-encoder path);
# GQA groups of 7 (yi-34b, 56/8), 6 (grok-1, 48/8) and 2 (gemma3, 32/16),
# and gemma3 as published at 2048 tokens: its local layers (window 1024)
# and its global ones (no window)
ATTN_TIMED = [("yi-6b", 1, 128, 128, 32, 4, 128, True, 0),
              ("yi-6b", 1, 256, 256, 32, 4, 128, True, 0),
              ("yi-6b", 1, 512, 512, 32, 4, 128, True, 0),
              ("yi-6b", 128, 128, 128, 32, 4, 128, True, 0),
              ("zamba2-1.2b", 1, 4096, 4096, 32, 32, 64, True, 4096),
              ("zamba2-1.2b", 128, 128, 128, 32, 32, 64, True, 4096),
              ("mixtral-8x7b", 128, 128, 128, 32, 8, 128, True, 4096),
              ("mixtral-8x7b", 1, 4224, 4224, 32, 8, 128, True, 4096),
              ("seamless-m4t-medium encoder", 1, 1024, 1024, 16, 16, 64, False, 0),
              ("seamless-m4t-medium cross", 128, 128, 32, 16, 16, 64, False, 0),
              ("seamless-m4t-medium cross", 1, 128, 1024, 16, 16, 64, False, 0),
              ("qwen2-vl-72b", 1, 128, 128, 64, 8, 128, True, 0),
              ("qwen2-vl-72b", 128, 128, 128, 64, 8, 128, True, 0),
              ("zamba2-1.2b train", 8, 2048, 2048, 32, 32, 64, True, 4096),
              ("yi-34b", 1, 128, 128, 56, 8, 128, True, 0),
              ("yi-34b", 128, 128, 128, 56, 8, 128, True, 0),
              ("grok-1-314b", 1, 128, 128, 48, 8, 128, True, 0),
              ("grok-1-314b", 128, 128, 128, 48, 8, 128, True, 0),
              ("gemma3-27b", 1, 128, 128, 32, 16, 128, True, 0),
              ("gemma3-27b", 128, 128, 128, 32, 16, 128, True, 0),
              ("gemma3-27b local", 1, 2048, 2048, 32, 16, 128, True, 1024),
              ("gemma3-27b global", 1, 2048, 2048, 32, 16, 128, True, 0)]
ATTN_HEADLINE = (1, 128)                 # (batch, prompt length) reported in the summary
SSM_HEADLINE = "zamba2 B=128 L=128"      # the scan shape reported in the summary

KERNELS = {"photonic_mac": photonic_mac, "flash_attention": flash_attention,
           "ssm_scan": ssm_scan}
# names of the port's CUDA kernels, as the profiler shows them
PORT_KERNEL_NAMES = ("mac_kernel", "attn_kernel", "ssm_scan_kernel")
ATTN_KINDS = ("attn", "local", "global", "shared_attn", "moe", "enc", "dec")
# the profiler ranges of `models/layers.py` and `models/model.py`
# (`layers._span`); `encode` holds its blocks' `attention` ranges
SPANS = ("attention", "cross_attention", "encode", "moe.route", "moe.dispatch",
         "moe.experts", "moe.combine")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def excess(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """How far the worst element of `got` lies outside `want`'s tolerance
    (> 0: `compare` fails)."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def compare(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float, what: str) -> dict:
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: bad shape or non-finite values")
    diff = (got - want).abs()
    excess = float((diff - (atol + rtol * want.abs())).max())
    res = {"what": what, "max_abs_err": float(diff.max()),
           "max_rel_err": float(diff.max() / want.abs().max().clamp_min(1e-30)),
           "rtol": rtol, "atol": atol}
    if excess > 0:
        raise AssertionError(f"kernel disagrees with its plain version: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def _ptxas_lines() -> list:
    """Registers, stack and spills of each kernel from the build's `ptxas -v`
    output, each line led by the (mangled) name of its kernel."""
    out, name = [], "?"
    for ln in _build.build_log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif ("registers" in ln or "wgmma" in ln
              or ("spill" in ln and "0 bytes spill" not in ln)):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def phase_device(build: bool = True) -> dict:
    """The card's name and power limit, versions, and (with `build`) the
    kernels' build; the engine phases alone need no build."""
    smi = card()
    if build:
        _build.library()
    info = {"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0],
            "build_seconds": round(_build.build_seconds, 2) if build else None,
            "ptxas": _ptxas_lines()}
    emit(info)
    return info


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _mac_inputs(gen, m, k, n, dtype, bits):
    x = torch.randn((m, k), generator=gen, device=DEV).to(dtype)
    w = torch.randn((k, n), generator=gen, device=DEV)
    w_q, sc = quantize_weights(w, bits=bits)
    return x, w_q, sc


def _same_rows(x, w_q, sc, rows: int, what: str, tensor_cores: bool = True) -> None:
    """The first `rows` rows of x alone give bit for bit the rows they give
    among all of x's rows."""
    full = photonic_mac(x, w_q, sc, tensor_cores=tensor_cores)
    part = photonic_mac(x[:rows].contiguous(), w_q, sc, tensor_cores=tensor_cores)
    torch.cuda.synchronize()
    if not torch.equal(part, full[:rows]):
        raise AssertionError(f"photonic_mac: rows differ with and without rows below them ({what})")


def check_photonic_mac(gen) -> dict:
    checks, timed = [], []
    # the reference's kernel-test shapes
    for (m, k, n) in [(128, 128, 128), (256, 384, 128), (128, 256, 512), (384, 128, 256)]:
        for dtype in (torch.float32, torch.bfloat16):
            for bits in (8, 4):
                x, w_q, sc = _mac_inputs(gen, m, k, n, dtype, bits)
                tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
                checks.append(compare(photonic_mac(x, w_q, sc), ref.photonic_mac_ref(x, w_q, sc),
                                      tol, tol * 10, f"mac {m}x{k}x{n} {dtype} bits{bits}"))
    # ragged shapes (bf16 ones with K or N off the bank grid take the FMA
    # kernel), and ragged M on shapes whose K the tensor-core kernel splits
    for (m, k, n) in [(100, 128, 128), (128, 200, 300), (1, 128, 50257 % 512), (130, 129, 131),
                      (130, 136, 144)]:
        for dtype in (torch.float32, torch.bfloat16):
            x, w_q, sc = _mac_inputs(gen, m, k, n, dtype, 8)
            tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
            checks.append(compare(photonic_mac(x, w_q, sc), ref.photonic_mac_ref(x, w_q, sc),
                                  tol, tol * 10, f"mac ragged {m}x{k}x{n} {dtype}"))
    for (m, k, n) in [(1, 4096, 512), (130, 4096, 512), (1, 11008, 4096), (130, 11008, 4096),
                      (100, 1024, 1024)]:
        x, w_q, sc = _mac_inputs(gen, m, k, n, torch.bfloat16, 8)
        _, plan = dispatch(x, w_q)
        checks.append({**compare(photonic_mac(x, w_q, sc), ref.photonic_mac_ref(x, w_q, sc),
                                 2e-2, 2e-1, f"mac ragged {m}x{k}x{n} bf16"),
                       "plan": plan.as_dict()})
    # rows must not depend on how many rows lie below them: both kernels,
    # and the tensor-core kernel on shapes it splits along K, where the row
    # tile it picks changes with M and the K ranges must not
    for dtype in (torch.float32, torch.bfloat16):
        x, w_q, sc = _mac_inputs(gen, 128, 256, 256, dtype, 8)
        for tc in (True, False):
            _same_rows(x, w_q, sc, 100, f"{dtype}, tensor_cores={tc}", tensor_cores=tc)
        checks.append({"what": f"mac bit-identity 100 of 128 rows {dtype}", "max_abs_err": 0.0})
    # (16 and 100 rows take a cluster split; 16384 rows sum the same ranges
    # in turn in each block); gemma3's wk/wv split 42 banks into ranges of
    # 10, 11, 10 and 11, yi-34b's and grok-1's 56 and 48 into 8 of 7 and 6
    for (k, n) in [(11008, 4096), (4096, 512), (1024, 1024), (5376, 2048), (7168, 1024),
                   (6144, 1024)]:
        for m_full in (128, 512, 16384):
            x, w_q, sc = _mac_inputs(gen, m_full, k, n, torch.bfloat16, 8)
            for rows in (16, 100):
                _same_rows(x, w_q, sc, rows, f"{rows} of {m_full} rows, K={k} N={n}")
            plan = mac_plan(m_full, k, n)
            sizes = [hi - lo for lo, hi in mac_ranges(k, plan.splits)]
            checks.append({"what": f"mac bit-identity 16 and 100 of {m_full} rows, K={k} N={n}, "
                                   f"{plan.splits} K ranges of {sizes} banks on a cluster of "
                                   f"{plan.cluster}",
                           "max_abs_err": 0.0})
            del x, w_q, sc
    # the serving shapes, bf16 activations as on the path; the tensor-core
    # kernel also within 1e-4 of the largest output (exact products, f32
    # sums: only the order of summation differs from the plain version)
    for (model, m, k, n) in MAC_TIMED:
        x, w_q, sc = _mac_inputs(gen, m, k, n, torch.bfloat16, 8)
        rows = m if m * n <= MAC_PLAIN_ELEMS else MAC_PLAIN_ROWS
        what = f"mac {model} {m}x{k}x{n} bf16" + (f" (first {rows} rows)" if rows < m else "")
        want = ref.photonic_mac_ref(x[:rows], w_q, sc)
        got = photonic_mac(x, w_q, sc)[:rows]
        checks.append(compare(got, want, 2e-2, 2e-1, what))
        checks.append(compare(got, want, 0.0, 1e-4 * float(want.abs().max()),
                              what + ", within 1e-4 of the largest output"))
        del got
        checks.append(compare(photonic_mac(x, w_q, sc, tensor_cores=False)[:rows], want,
                              2e-2, 2e-1, what + ", f32 FMA kernel"))
        del want
        w_bf16 = ref.dequantize_ref(w_q, sc).to(torch.bfloat16)
        kernel, plan = dispatch(x, w_q)
        row = {"model": model, "shape": [m, k, n], "dtype": "bfloat16",
               "kernel": kernel, "plan": plan.as_dict() if plan else None,
               "ms": time_ms(lambda: photonic_mac(x, w_q, sc)),
               "fma_kernel_ms": time_ms(lambda: photonic_mac(x, w_q, sc, tensor_cores=False)),
               "plain_ms": time_ms(lambda: ref.photonic_mac_ref(x, w_q, sc)),
               "library_ms": time_ms(lambda: torch.matmul(x, w_bf16)),
               **mac_bound_ms(m, k, n, torch.bfloat16)}
        row["tflops"] = 2.0 * m * k * n / row["ms"] / 1e9
        timed.append(row)
        del w_bf16
    return {"checks": checks, "timed": timed, "shards": _mac_shards(gen, checks)}


def _mac_shards(gen, checks: list) -> list:
    """`MAC_SHARD`'s padded column shards: each rank's slice zero-padded out
    to the global bank edges, quantized with the global weight's bank
    maxima (its levels and scales those of the global quantization), the
    kernel on whole banks, the padding sliced off; held against the plain
    version of the same padded product and against the slice's columns of
    the global product (its K ranges may differ: within 1e-4 of the
    largest output), and timed beside the unpadded global product."""
    m, k, n, parts = MAC_SHARD
    x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=DEV)
    absmax = bank_absmax(w)
    w_q, sc = quantize_weights(w, bits=8)
    whole = photonic_mac(x, w_q, sc)
    rows = []
    for r in MAC_SHARD_RANKS:
        size = n // parts
        cols = slice(r * size, (r + 1) * size)
        xp, wp, lo, off = ops.shard_banks(x, w[:, cols], "cols", r)
        banks = wp.shape[1] // BANK
        sq, ssc = quantize_weights(wp, bits=8, absmax=absmax[:, lo:lo + banks])
        if not (torch.equal(sq[:, off:off + size], w_q[:, cols])
                and torch.equal(ssc, sc[:, lo:lo + banks])):
            raise AssertionError(f"photonic_mac shard {r}: levels or scales differ from the "
                                 "global weight's")
        got = photonic_mac(xp, sq, ssc)[:, off:off + size]
        want = ref.photonic_mac_ref(xp, sq, ssc)[:, off:off + size]
        what = f"mac shard {r} of {parts}: {m}x{k}x{size} of {n} columns, padded to {wp.shape[1]}"
        checks.append(compare(got, want, 2e-2, 2e-1, what))
        checks.append(compare(got, whole[:, cols], 0.0, 1e-4 * float(whole.abs().max()),
                              what + ", against the global product's columns"))
        kernel, plan = dispatch(xp, sq)
        rows.append({"rank": r, "shape": [m, k, size], "padded_columns": wp.shape[1],
                     "first_bank": lo, "kernel": kernel, "plan": plan.as_dict(),
                     "ms": time_ms(lambda: photonic_mac(xp, sq, ssc)),
                     "plain_ms": time_ms(lambda: ref.photonic_mac_ref(xp, sq, ssc)),
                     "global_ms": time_ms(lambda: photonic_mac(x, w_q, sc)),
                     **mac_bound_ms(m, k, size, torch.bfloat16)})
    return rows


def _attn_inputs(gen, b, hq, hk, sq, sk, d, dtype, model_layout=False):
    """q, k, v as (B,H,S,D); with `model_layout`, strided views of (B,S,H,D)
    tensors, which is how `layers.apply_attention` hands them over."""
    def mk(h, s):
        if model_layout:
            return torch.randn((b, s, h, d), generator=gen, device=DEV).to(dtype).movedim(2, 1)
        return torch.randn((b, h, s, d), generator=gen, device=DEV).to(dtype)
    return mk(hq, sq), mk(hk, sk), mk(hk, sk)


def attn_bound_ms(b, hq, hk, sq, sk, d, dtype, causal, window, q_offset) -> dict:
    q_pos = q_offset + torch.arange(sq)[:, None]
    k_pos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    pairs = int(mask.sum())                      # (query, key) pairs this mask needs
    esize = 2 if dtype == torch.bfloat16 else 4
    nbytes = esize * b * d * (hq * sq + 2 * hk * sk) + 4 * b * hq * sq * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * d * pairs * b * hq / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _other_order_out(q, k, v, plan, kw) -> tuple:
    """`attn_kernel_sm90`'s output in the grid order its plan did not pick,
    and that plan."""
    b, hq, sq, d = q.shape
    other = dataclasses.replace(plan, heavy_first=not plan.heavy_first)
    out = torch.empty((b, hq, sq, d), dtype=torch.float32, device=DEV)
    _build.check_launch(FA._launch_sm90(q, k, v, out, d ** -0.5, kw["causal"], kw["window"],
                                        kw["q_offset"], other), "flash_attention (other order)")
    return out, other


def _attn_other_order(q, k, v, want, plan, kw, what) -> dict:
    """`attn_kernel_sm90` in the grid order its plan did not pick, held to
    the same tolerance (so both of the kernel's maps from block to query
    tile are checked)."""
    out, other = _other_order_out(q, k, v, plan, kw)
    return {**compare(out, want, 2e-2, 2e-2,
                      what + f", heavy_first={other.heavy_first}"),
            "kernel": "attn_kernel_sm90", "plan": other.as_dict()}


# The tolerance that holds `attn_kernel_sm90` in the rows where the window
# masks keys that causality keeps (`_window_checks`): no rtol, and an atol
# between the kernel's own error there and what a wrong window moves (both
# printed)
WINDOW_ATOL = 1e-3


def _window_checks(q, k, v, want, plan, window, what) -> list:
    """At S > window with N(0,1) inputs a row past the window averages about
    `window` values, so its outputs are about window^-0.5 (0.016 at 4096)
    and bf16's 2e-2 would pass a kernel that ignored the window or skipped
    a key tile.  So the rows past the window (the only rows where it masks
    anything, and where its tiles are skipped) are held again:
    `attn_kernel_sm90`, in both grid orders, to `WINDOW_ATOL` alone; the
    FMA kernel, on the bf16 inputs and on the same values in f32, to
    rtol = atol = 2e-5 over every row.  The plain version with the window
    off, one 64-key tile short, and one key short or long must fail each of
    these compares."""
    kw = dict(causal=True, window=window, q_offset=0)
    past = slice(window, None)                  # query rows past the window

    def rows(t, sel):
        return t[:, :, sel] if sel else t

    controls = {f"window {w}": ref.attention_ref(q, k, v, window=w)
                for w in (0, window - 64, window - 1, window + 1)}
    other, other_plan = _other_order_out(q, k, v, plan, kw)
    runs = [("attn_kernel_sm90, rows past the window",
             flash_attention(q, k, v, window=window), past, 0.0, WINDOW_ATOL),
            (f"attn_kernel_sm90 heavy_first={other_plan.heavy_first}, rows past the window",
             other, past, 0.0, WINDOW_ATOL),
            ("attn_kernel (FMA), bf16 inputs",
             flash_attention(q, k, v, window=window, tensor_cores=False), None, 2e-5, 2e-5),
            ("attn_kernel (FMA), the same values in f32",
             flash_attention(q.float(), k.float(), v.float(), window=window), None, 2e-5, 2e-5)]
    checks = []
    for name, got, sel, rtol, atol in runs:
        w = rows(want, sel)
        row = {**compare(rows(got, sel), w, rtol, atol, f"{what}, window held, {name}"),
               "all_rows_max_abs_err": float((got - want).abs().max()),
               "plain_version_error_with_window": {
                   c: float((rows(t, sel) - w).abs().max()) for c, t in controls.items()},
               "plain_version_fails_with_window": {
                   c: excess(rows(t, sel), w, rtol, atol) > 0 for c, t in controls.items()}}
        if not all(row["plain_version_fails_with_window"].values()):
            raise AssertionError(f"the window check cannot see a wrong window: {row}")
        checks.append(row)
    del controls, other, runs
    return checks


def _sdpa(q, kr, vr, causal, window):
    """One `scaled_dot_product_attention` call computing the kernel's
    function: no mask, or causal (`is_causal`) where the window masks
    nothing that causality keeps, else an explicit mask."""
    s = q.shape[2]
    if not causal:
        return lambda: torch.nn.functional.scaled_dot_product_attention(q, kr, vr)
    if window and s > window:
        pos = torch.arange(s, device=DEV)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        return lambda: torch.nn.functional.scaled_dot_product_attention(q, kr, vr,
                                                                        attn_mask=mask)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, kr, vr, is_causal=True)


def check_flash_attention(gen) -> dict:
    checks, timed = [], []
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for (sq, sk, hq, hk, d) in [(128, 128, 4, 4, 64), (256, 256, 8, 2, 64), (128, 256, 8, 1, 128),
                                (512, 512, 2, 2, 32), (128, 384, 16, 8, 64)]:
        for window in (0, 64):
            cases.append((2, hq, hk, sq, sk, d, f32, True, window, sk - sq))
    cases += [
        (1, 4, 4, 128, 128, 64, bf16, True, 0, 0),          # the reference's bf16 case
        (2, 8, 2, 256, 256, 64, bf16, True, 64, 0),         # the f32 cases again in bf16,
        (2, 2, 2, 512, 512, 32, bf16, True, 0, 0),          # one per head size
        (2, 4, 2, 100, 100, 16, bf16, True, 24, 0),
        (1, 2, 2, 128, 128, 32, bf16, False, 0, 0),
        (1, 2, 2, 16, 16, 16, bf16, True, 4, 32),           # fully masked rows in bf16
        (1, 2, 2, 128, 128, 32, f32, False, 0, 0),          # non-causal
        (2, 4, 2, 40, 40, 16, f32, True, 0, 0),             # ragged: S below one tile
        (2, 4, 2, 100, 100, 16, f32, True, 24, 0),          # ragged: S between tiles
        (1, 2, 2, 16, 16, 16, f32, True, 4, 32),            # fully masked rows: no tile skipping
        (1, 8, 2, 128, 384, 128, bf16, True, 64, 256),
        (1, 4, 2, 200, 150, 64, f32, True, 0, 0),           # causal, Sq > Sk: still skips
    ]
    # no mask at Sq != Sk, seamless's heads (16/16 of 64): its decoder's
    # cross-attention against 32 frames (below one KV tile) and 1024, its
    # encoder over 1024 frames, and a ragged pair
    for (sq, sk) in [(128, 32), (128, 1024), (1024, 1024), (100, 40)]:
        cases += [(1, 16, 16, sq, sk, 64, dtype, False, 0, 0) for dtype in (bf16, f32)]
    # the tensor-core kernel's edges, at both of its head sizes: rows masked
    # everywhere (all of them, and some beside rows that see keys, with Sk
    # ragged), queries past the last key under a causal mask alone (no row
    # masked everywhere, so tiles are skipped), Sk below one KV tile, between
    # tiles and past two, a query offset with a window and GQA group 8, and
    # no mask at all
    for d in (64, 128):
        cases += [
            (1, 2, 2, 64, 64, d, bf16, True, 16, 128),        # every row fully masked
            (2, 4, 2, 128, 100, d, bf16, True, 32, 64),       # some rows fully masked
            (1, 4, 2, 200, 150, d, bf16, True, 0, 0),         # none: causal alone skips tiles
            (2, 4, 2, 40, 40, d, bf16, True, 0, 0),           # ragged: Sk below one tile
            (2, 4, 2, 100, 100, d, bf16, True, 24, 0),        # ragged: Sk between tiles
            (1, 8, 4, 200, 200, d, bf16, True, 0, 0),         # ragged: past two tiles
            (1, 16, 2, 128, 384, d, bf16, True, 64, 256),     # q_offset, window, GQA 8
            (1, 4, 4, 200, 200, d, bf16, False, 0, 0),        # no mask, ragged
        ]
    for (b, hq, hk, sq, sk, d, dtype, causal, window, off) in cases:
        q, k, v = _attn_inputs(gen, b, hq, hk, sq, sk, d, dtype)
        kw = dict(causal=causal, window=window, q_offset=off)
        what = (f"attn b{b} hq{hq} hk{hk} sq{sq} sk{sk} d{d} {dtype} causal{int(causal)} "
                f"w{window} off{off}")
        want = ref.attention_ref(q, k, v, **kw)
        kernel, plan = FA.dispatch(q, k, v, **kw)
        if d in FA.SM90_HEAD_DIMS and dtype == bf16 and kernel != "attn_kernel_sm90":
            raise AssertionError(f"{what} did not reach attn_kernel_sm90")
        if dtype == bf16:    # both kernels that take bf16, at bf16's tolerance
            checks.append({**compare(flash_attention(q, k, v, **kw), want, 2e-2, 2e-2, what),
                           "kernel": kernel, "plan": plan.as_dict() if plan else None})
            checks.append(compare(flash_attention(q, k, v, tensor_cores=False, **kw), want,
                                  2e-2, 2e-2, what + ", f32 FMA kernel"))
            if plan is not None and plan.q_tiles > 1:   # the other grid order too
                checks.append(_attn_other_order(q, k, v, want, plan, kw, what))
        else:
            checks.append(compare(flash_attention(q, k, v, **kw), want, 2e-5, 2e-5, what))
    # the prefill shapes, timed
    for (model, b, sq, sk, hq, hk, d, causal, window) in ATTN_TIMED:
        q, k, v = _attn_inputs(gen, b, hq, hk, sq, sk, d, bf16, model_layout=True)
        kw = dict(causal=causal, window=window, q_offset=0)
        what = f"attn {model} b{b} sq{sq} sk{sk} causal{int(causal)} bf16"
        kernel, plan = FA.dispatch(q, k, v, **kw)
        if kernel != "attn_kernel_sm90":
            raise AssertionError(f"{what} did not reach attn_kernel_sm90")
        if b == 1:
            want = ref.attention_ref(q, k, v, **kw)
            checks.append(compare(flash_attention(q, k, v, **kw), want, 2e-2, 2e-2, what))
            checks.append(_attn_other_order(q, k, v, want, plan, kw, what))
            if window and sq > window:
                checks += _window_checks(q, k, v, want, plan, window, what)
            del want
        else:   # the plain version would hold (128,H,128,128) f32 scores twice: check 4 rows
            out = flash_attention(q, k, v, **kw)
            checks.append(compare(out[:4], ref.attention_ref(q[:4], k[:4], v[:4], **kw),
                                  2e-2, 2e-2, what + " (first 4 of batch)"))
        kr, vr = k.repeat_interleave(hq // hk, dim=1), v.repeat_interleave(hq // hk, dim=1)
        library = _sdpa(q, kr, vr, causal, window)
        row = {"model": model, "shape": {"b": b, "hq": hq, "hk": hk, "sq": sq, "sk": sk, "d": d},
               "causal": causal, "window": window, "dtype": "bfloat16", "kernel": kernel,
               "plan": plan.as_dict(),
               "ms": time_ms(lambda: flash_attention(q, k, v, **kw)),
               "fma_kernel_ms": time_ms(lambda: flash_attention(q, k, v, tensor_cores=False,
                                                                **kw)),
               "plain_ms": time_ms(lambda: ref.attention_ref(q, k, v, **kw)),
               "library_ms": time_ms(library),
               **attn_bound_ms(b, hq, hk, sq, sk, d, bf16, causal, window, 0)}
        timed.append(row)
        del q, k, v, kr, vr
    return {"checks": checks, "timed": timed}


def _ssm_inputs(gen, bh, l, p, n, dtypes=("f32", "f32", "f32"), decay=(0.68, 0.98), groups=None):
    """The reference tests' distribution (x * 0.5, b and c * 0.3, a in
    `decay`); x, b and c each cast to its own dtype, a f32.  b and c have
    `groups` rows (default: one per head)."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = bh if groups is None else groups
    x = (torch.randn((bh, l, p), generator=gen, device=DEV) * 0.5).to(dt[dtypes[0]])
    a = decay[0] + (decay[1] - decay[0]) * torch.sigmoid(
        torch.randn((bh, l), generator=gen, device=DEV))
    b = (torch.randn((g, l, n), generator=gen, device=DEV) * 0.3).to(dt[dtypes[1]])
    c = (torch.randn((g, l, n), generator=gen, device=DEV) * 0.3).to(dt[dtypes[2]])
    return x, a, b, c


def ssm_bound_ms(x, a, b, c) -> dict:
    """Bytes: each input read once (b and c at the size the grouped form
    reads, one row per group), y (BH,L,P) f32 written once.  Operations:
    the recurrence's 5 per state entry and step (a*S, x*b, their sum, and
    the multiply-add of S c), on the f32 pipe: the kernel must compute in f32
    from these values.  (The chunked closed form takes more: 2C(N+P) + 4PN
    per step for chunk C.)"""
    bh, l, p = x.shape
    n = b.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x, a, b, c)) + 4 * bh * l * p
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 5.0 * bh * l * p * n / PEAK_FLOPS[torch.float32] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# the scan's shapes on the serving paths: (name, BH, L, P, N, dtypes of x, b, c,
# b/c groups); zamba2's 64 heads of a batch row share one b and c
SSM_PATH = [
    ("zamba2 B=128 L=128", 128 * 64, 128, 64, 64, ("bf16", "bf16", "bf16"), 128),
    ("zamba2 B=1 L=97", 64, 97, 64, 64, ("bf16", "bf16", "bf16"), 1),
    ("zamba2 B=1 L=4096", 64, 4096, 64, 64, ("bf16", "bf16", "bf16"), 1),
    ("xlstm B=128 L=128", 128 * 4, 128, 256, 256, ("bf16", "bf16", "bf16"), 128 * 4),
    ("xlstm normaliser B=128 L=128", 128 * 4, 128, 1, 256, ("f32", "bf16", "bf16"), 128 * 4),
    ("zamba2 train B=8 L=2048", 8 * 64, 2048, 64, 64, ("bf16", "bf16", "bf16"), 8),
]


def _ssm_want(x, a, b, c):
    bh = x.shape[0]
    return ref.ssm_scan_ref(x, a, SS.expand_groups(b, bh), SS.expand_groups(c, bh))


def check_ssm_scan(gen) -> dict:
    """The kernel against the sequential oracle `ref.ssm_scan_ref` fed the
    same values upcast to f32 (b and c repeated per head for the grouped
    form), at rtol = atol = 2e-4 (the reference test's bound): both scan in
    f32, and differ in the order of the sum over N and in one fused
    multiply-add per update."""
    checks, timed = [], []
    tol = 2e-4

    def check(x, a, b, c, what):
        plan = SS.ssm_plan(x.shape[0], b.shape[0], x.shape[1], x.shape[2], b.shape[2],
                           tuple(SS._dtype_name(t) for t in (x, b, c)))
        if what.startswith("ssm chunked") and plan.chunks == 1:
            raise AssertionError(f"{what}: the rule's plan does not chunk: {plan}")
        checks.append({**compare(ssm_scan(x, a, b, c), _ssm_want(x, a, b, c), tol, tol, what),
                       "plan": plan.as_dict()})

    # the reference's kernel-test shapes, f32, and its bf16 case
    for (bh, l, p, n) in [(2, 128, 16, 8), (4, 256, 32, 16), (1, 512, 64, 64), (8, 128, 8, 4),
                          (2, 1024, 32, 32)]:
        check(*_ssm_inputs(gen, bh, l, p, n), f"ssm {bh}x{l}x{p}x{n} f32")
    check(*_ssm_inputs(gen, 2, 256, 16, 8, ("bf16",) * 3), "ssm 2x256x16x8 bf16")
    # ragged chunk lengths (L <= 128 reaches the kernel whole), P = 1, mixed
    # dtypes, N that is not a multiple of the 16 entries a thread holds
    for l in (24, 97):
        for (p, dts) in ((1, ("f32", "bf16", "bf16")), (16, ("bf16",) * 3), (64, ("f32",) * 3)):
            check(*_ssm_inputs(gen, 3, l, p, 64, dts), f"ssm 3x{l}x{p}x64 {'/'.join(dts)}")
    check(*_ssm_inputs(gen, 2, 100, 5, 100, ("bf16", "f32", "bf16")), "ssm 2x100x5x100 mixed")
    check(*_ssm_inputs(gen, 2, 100, 5, 100, ("bf16",) * 3), "ssm 2x100x5x100 bf16")  # b, c rows not 16 B
    # L that does not tile into 128-step chunks (the model's 200-token prefill)
    check(*_ssm_inputs(gen, 4, 200, 64, 64, ("bf16",) * 3, groups=1), "ssm 4x200x64x64 bf16 G=1")
    # wide: a ragged last time tile and a partial tile of rows (40 of 64),
    # and two tiles of rows (100 of 128)
    check(*_ssm_inputs(gen, 16384, 97, 40, 64, ("f32", "bf16", "bf16")), "ssm 16384x97x40x64 mixed")
    check(*_ssm_inputs(gen, 2048, 64, 100, 256, ("bf16",) * 3), "ssm 2048x64x100x256 bf16")
    # the grouped b/c form: 64 heads a group (zamba2) and 4, bf16 and f32
    for (bh, g, l, p, n, dts) in [(1024, 16, 128, 64, 64, ("bf16",) * 3),
                                  (256, 64, 97, 64, 64, ("bf16",) * 3),
                                  (64, 16, 130, 32, 48, ("f32",) * 3),
                                  (128, 2, 256, 64, 64, ("f32", "bf16", "bf16"))]:
        check(*_ssm_inputs(gen, bh, l, p, n, dts, groups=g),
              f"ssm grouped {bh}x{l}x{p}x{n} G={g} (H={bh // g}) {'/'.join(dts)}")
    # chunk-parallel (the rule's: 8 chunks of 512 at B=1 L=4096), at strong
    # decay too, where products of decays across a chunk underflow; a ragged
    # last chunk; the normaliser's P = 1 form over 4 chunks
    for decay in ((0.68, 0.98), (0.05, 0.35)):
        check(*_ssm_inputs(gen, 64, 4096, 64, 64, ("bf16",) * 3, decay=decay, groups=1),
              f"ssm chunked 64x4096x64x64 G=1 bf16 decay {decay}")
    check(*_ssm_inputs(gen, 64, 4000, 64, 64, ("bf16",) * 3, groups=1),
          "ssm chunked 64x4000x64x64 G=1 bf16, ragged last chunk")
    check(*_ssm_inputs(gen, 8, 2048, 1, 256, ("f32", "bf16", "bf16")),
          "ssm chunked 8x2048x1x256 normaliser form")
    # chunked plans the rule does not pick: one row a thread, chunks of 64,
    # rows past P (37 of 64) and N below a thread row's width, f32; the
    # normaliser's P = 1 form in 128-step chunks with a ragged last one
    for (bh, g, l, p, n, dts, kw) in [
            (16, 4, 1000, 37, 20, ("f32",) * 3, dict(rt=1, ns=8, chunk=64)),
            (8, 8, 700, 64, 64, ("bf16",) * 3, dict(rt=4, ns=16, chunk=256, t_tile=16)),
            (8, 8, 1000, 1, 256, ("f32", "bf16", "bf16"), dict(chunk=128))]:
        x, a, b, c = _ssm_inputs(gen, bh, l, p, n, dts, groups=g)
        plan = SS.ssm_plan(bh, g, l, p, n, dts, **kw)
        y = torch.empty((bh, l, p), dtype=torch.float32, device=DEV)
        _build.check_launch(SS.launch(x, a, b, c, y, plan, SS.chunk_scratch(x, n, plan)),
                            "ssm_scan (forced plan)")
        checks.append({**compare(y, _ssm_want(x, a, b, c), tol, tol,
                                 f"ssm chunked {bh}x{l}x{p}x{n} G={g} {'/'.join(dts)}, plan {kw}"),
                       "plan": plan.as_dict()})
    # strong decay, where a ratio of cumulative products would underflow
    for decay in ((0.3, 0.6), (0.05, 0.35)):
        check(*_ssm_inputs(gen, 2, 128, 8, 4, decay=decay), f"ssm 2x128x8x4 decay {decay}")
        check(*_ssm_inputs(gen, 64, 512, 64, 64, ("bf16",) * 3, decay=decay),
              f"ssm 64x512x64x64 bf16 decay {decay}")
    # the serving paths' shapes, timed
    for (name, bh, l, p, n, dts, g) in SSM_PATH:
        x, a, b, c = _ssm_inputs(gen, bh, l, p, n, dts, groups=g)
        check(x, a, b, c, f"ssm {name}")
        be, ce = SS.expand_groups(b, bh), SS.expand_groups(c, bh)
        plan = SS.ssm_plan(bh, g, l, p, n, dts)
        timed.append({"shape": {"name": name, "bh": bh, "l": l, "p": p, "n": n, "groups": g},
                      "dtypes": {"x": dts[0], "b": dts[1], "c": dts[2]}, "plan": plan.as_dict(),
                      "ms": time_ms(lambda: ssm_scan(x, a, b, c)),
                      "plain_ms": time_ms(lambda: ref.ssm_scan_ref(x, a, be, ce)),
                      "chunked_plain_ms": time_ms(lambda: ref.ssm_scan_chunked_ref(x, a, be, ce)),
                      "library_ms": None, **ssm_bound_ms(x, a, b, c)})
        del x, a, b, c, be, ce
    return {"checks": checks, "timed": timed}


def quantize_cost_ms(gen) -> dict:
    """Device time of re-quantizing the master weights, which `photonic_matmul`
    does on every call: per yi-6b matrix, and summed over one decode step
    (seven matrices in each of 32 layers, plus the head)."""
    per = {}
    for (k, n) in YI_KN:
        w = torch.randn((k, n), generator=gen, device=DEV)
        per[f"{k}x{n}"] = time_ms(lambda: quantize_weights(w, bits=8))
        del w
    layer = (2 * per["4096x4096"] + 2 * per["4096x512"] + 2 * per["4096x11008"]
             + per["11008x4096"])
    return {"per_matrix_ms": per, "per_decode_step_ms": 32 * layer + per["4096x64000"]}


def phase_kernels(only: str | None = None) -> dict:
    """Every kernel against its plain version; with `only` = "photonic_mac",
    "flash_attention" or "ssm_scan", that kernel's comparisons alone."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    before = counters()
    parts, checks = {}, []
    if only in (None, "photonic_mac"):
        mac = check_photonic_mac(gen)
        checks += mac["checks"]
        parts["photonic_mac"] = {
            "n_checks": len(mac["checks"]),
            "max_abs_err": max(c["max_abs_err"] for c in mac["checks"]),
            "max_rel_err": max(c.get("max_rel_err", 0.0) for c in mac["checks"]),
            "tolerance": "f32 rtol 1e-4 atol 1e-3; bf16 rtol 2e-2 atol 2e-1, and at the "
                         "serving shapes also within 1e-4 of the largest output; "
                         "padded rows bit-identical; a padded shard's levels and scales "
                         "equal the global weight's, its columns within 1e-4 of the "
                         "global product's largest output",
            "timed": mac["timed"], "shards": mac["shards"]}
    if only in (None, "flash_attention"):
        attn = check_flash_attention(gen)
        checks += attn["checks"]
        parts["flash_attention"] = {
            "n_checks": len(attn["checks"]),
            "max_abs_err": max(c["max_abs_err"] for c in attn["checks"]),
            "max_rel_err": max(c["max_rel_err"] for c in attn["checks"]),
            "window_checks": [c for c in attn["checks"] if "window held" in c["what"]],
            "tolerance": "f32 rtol=atol 2e-5; bf16 rtol=atol 2e-2; where the window masks "
                         f"keys that causality keeps, also atol {WINDOW_ATOL} alone "
                         "(attn_kernel_sm90, rows past the window) and rtol=atol 2e-5 "
                         "(FMA kernel), which the plain version with a wrong window fails",
            "timed": attn["timed"]}
    if only in (None, "ssm_scan"):
        ssm = check_ssm_scan(gen)
        checks += ssm["checks"]
        parts["ssm_scan"] = {
            "n_checks": len(ssm["checks"]),
            "max_abs_err": max(c["max_abs_err"] for c in ssm["checks"]),
            "max_rel_err": max(c["max_rel_err"] for c in ssm["checks"]),
            "tolerance": "rtol=atol 2e-4 against the sequential oracle fed the same values "
                         "in f32",
            "timed": ssm["timed"]}
    if only is None:
        parts["quantize_weights"] = quantize_cost_ms(gen)
    launched = {name: n - before[name] for name, n in counters().items()}
    if any(launched[name] == 0 for name in parts if name in KERNELS):
        raise AssertionError(f"a kernel comparison launched no kernel: {launched}")
    out = {"phase": "kernels", **parts}
    emit(out)
    return {**out, "checks": checks}


# ---------------------------------------------------------------------------
# the analytic engine (`repro_torch.core`) in float64 on the card
# ---------------------------------------------------------------------------

ENGINE_RTOL = 1e-12          # card against the port's CPU evaluation
ENGINE_DISCRETE = ("n_wavelengths", "n_mr", "n_mzi", "n_stages", "n_laser_banks",
                   "is_electrical", "n_routers")
STREAM_TOPOLOGIES = ("sprint", "spacx", "tree", "trine")
# 4 x 8 x 5 x 5 x 4 x 4 x 4 x 4 x 4 x 4 x 3 = 9,830,400 configurations
STREAM_AXES = {
    "n_gateways": tuple(float(g) for g in range(8, 65, 8)),
    "n_lambda": (2.0, 4.0, 8.0, 16.0, 32.0),
    "mem_bw_bytes_per_s": (25e9, 50e9, 100e9, 200e9, 400e9),
    "modulation_rate_bps": (8e9, 10e9, 12e9, 16e9),
    "interposer_side_cm": (1.0, 2.0, 3.0, 4.0),
    "mzi.insertion_loss_db": (0.25, 0.5, 0.75, 1.0),
    "wg.propagation_loss_db_per_cm": (0.5, 1.0, 1.5, 2.0),
    "pd.sensitivity_dbm": (-28.0, -26.0, -24.0, -22.0),
    "laser.wall_plug_efficiency": (0.05, 0.1, 0.15, 0.2),
    "mr.tuning_power_w": (1.5e-4, 2.75e-4, 5e-4),
}
STREAM_CHUNK = 1 << 20
STREAM_SAMPLES = 4096
# the availability grid: the first six axes of the stream's (4 topologies x
# n_gateways x n_lambda x mem_bw x modulation x interposer x MZI loss) =
# 51,200 configurations, under 256 scenarios drawn with the fault rates of
# `benchmarks/resilience_bench.py`'s BASE_MODEL (FaultModel()'s zero rates
# would draw 256 healthy scenarios)
AVAIL_AXES = dict(list(STREAM_AXES.items())[:6])
AVAIL_SCENARIOS = 256
FAULT_RATES = dict(p_lambda=0.15, p_bank=0.12, p_gateway=0.05, wpe_loss=0.2,
                   drift_sigma_db=0.5, tuning_sigma=0.3)


def _max_rel(got, want) -> float:
    got, want = np.broadcast_arrays(np.asarray(got, np.float64), np.asarray(want, np.float64))
    if got.size == 0:
        return 0.0
    same = got == want                                # equal infinities count as equal
    with np.errstate(invalid="ignore"):
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    return float(np.max(np.where(same, 0.0, rel)))


def _hold(got, want, what: str, rtol: float = ENGINE_RTOL) -> float:
    """Max relative error of `got` against `want`; raises past `rtol`, or on
    any difference in a discrete field."""
    err = _max_rel(got, want)
    if what.split("/")[-1] in ENGINE_DISCRETE and err != 0.0:
        bad = np.flatnonzero(np.asarray(got) != np.asarray(want))[:8]
        raise AssertionError(f"{what}: discrete field differs between card and CPU at rows "
                             f"{bad.tolist()}")
    if not err <= rtol:
        raise AssertionError(f"{what}: card vs CPU max rel err {err:.3e} > {rtol:g}")
    return err


def _require_checks(checks: dict, what: str) -> None:
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"{what}: checks failed: {failed}")


def phase_engine_fig4() -> dict:
    """Paper Fig. 4 (`benchmarks/torch_fig4_trine.py`) on the card: every
    check True, every row and the network columns of all five topologies
    equal to the CPU's (continuous at ENGINE_RTOL, discrete exactly)."""
    from benchmarks import torch_fig4_trine as fig4
    cpu = fig4.run(csv=False, device="cpu")
    t0 = time.perf_counter()
    card = fig4.run(csv=False, device="cuda")
    seconds = time.perf_counter() - t0
    _require_checks(card["checks"], "engine_fig4")
    if card["params"] != cpu["params"]:
        raise AssertionError(f"engine_fig4: params differ {card['params']} vs {cpu['params']}")
    err = 0.0
    for a, b in zip(card["rows"], cpu["rows"]):
        assert (a["cnn"], a["network"]) == (b["cnn"], b["network"])
        for k, v in a.items():
            if not isinstance(v, str):
                err = max(err, _hold(v, b[k], f"fig4/{a['cnn']}/{a['network']}/{k}"))
    grid = EC.build_grid(ES.DEFAULT_TOPOLOGIES, n_gateways=(8, 16, 32, 64),
                         n_lambda=(4, 8, 16), mem_bw_bytes_per_s=(50e9, 100e9, 200e9))
    nets_card = EC.network_columns(grid, device="cuda")
    nets_cpu = EC.network_columns(grid, device="cpu")
    for f in nets_card:
        err = max(err, _hold(nets_card[f], nets_cpu[f], f"fig4 nets/{f}"))
    out = {"phase": "engine_fig4", "seconds": seconds, "checks": card["checks"],
           "params": card["params"], "rows": len(card["rows"]),
           "network_rows_checked": grid.n, "max_rel_err_vs_cpu": err,
           "discrete_fields_equal": True, "rtol": ENGINE_RTOL}
    emit(out)
    return out


def phase_engine_fig6() -> dict:
    """Paper Fig. 6 (`benchmarks/torch_fig6_crosslight.py`): the three
    CrossLight variants x six CNNs on the card, every check True, equal to
    the CPU at ENGINE_RTOL (its layer and chiplet sums are reductions, so
    held at a tolerance, not bitwise)."""
    from benchmarks import torch_fig6_crosslight as fig6
    cpu = fig6.run(csv=False, device="cpu")
    t0 = time.perf_counter()
    card = fig6.run(csv=False, device="cuda")
    seconds = time.perf_counter() - t0
    _require_checks(card["checks"], "engine_fig6")
    err = 0.0
    for a, b in zip(card["rows"], cpu["rows"]):
        for k, v in a.items():
            if isinstance(v, dict):
                for kk in v:
                    err = max(err, _hold(v[kk], b[k][kk], f"fig6/{a['cnn']}/{k}/{kk}"))
            elif not isinstance(v, str):
                err = max(err, _hold(v, b[k], f"fig6/{a['cnn']}/{k}"))
    for k in card["avg"]:
        err = max(err, _hold(card["avg"][k], cpu["avg"][k], f"fig6/avg/{k}"))
    out = {"phase": "engine_fig6", "seconds": seconds, "checks": card["checks"],
           "avg": card["avg"], "paper": card["paper"], "cells": 3 * len(card["rows"]),
           "max_rel_err_vs_cpu": err, "rtol": ENGINE_RTOL}
    emit(out)
    return out


class _Collect(ES.ChunkReducer):
    """Every chunk's metrics, concatenated (for the bitwise comparisons)."""

    def init(self, spec):
        return []

    def step(self, carry, chunk):
        carry.append({k: np.array(v) for k, v in chunk.metrics.items()})
        return carry

    def finish(self, carry, spec):
        return {k: np.concatenate([c[k] for c in carry], axis=-1) for k in carry[0]}


class _MinAndSample(ES.MinReducer):
    """The running argmin of `MinReducer`, plus every metric at the flat rows
    `rows` as the stream saw them (for the comparison with the CPU)."""

    def __init__(self, metric: str, rows):
        super().__init__(metric)
        self.rows = np.sort(np.asarray(rows, np.int64))

    def init(self, spec):
        return {"min": None, "sample": []}

    def step(self, carry, chunk):
        carry["min"] = super().step(carry["min"], chunk)
        lo, hi = np.searchsorted(self.rows, [chunk.start, chunk.stop])
        if hi > lo:
            loc = self.rows[lo:hi] - chunk.start
            carry["sample"].append({k: np.array(v[..., loc]) for k, v in chunk.metrics.items()})
        return carry

    def finish(self, carry, spec):
        out = super().finish(carry["min"], spec)
        out["sample"] = {k: np.concatenate([s[k] for s in carry["sample"]], axis=-1)
                         for k in carry["sample"][0]}
        return out


def _rows_cols(spec, rows):
    """Host columns and topology ids of arbitrary flat rows of `spec` (the
    mixed-radix decode of `GridSpec.chunk_cols`, row by row)."""
    rows = np.asarray(rows, np.int64)
    digits = np.unravel_index(rows, spec.shape)
    cols = {name: np.full(rows.size, v, np.float64) for name, v in spec.base.items()}
    for ai, (name, vals) in enumerate(spec.axes.items()):
        cols[name] = np.asarray(vals, np.float64)[digits[1 + ai]]
    return cols, np.asarray(digits[0])


def _cpu_metrics(spec, rows, traffics):
    """The port's CPU evaluation of `rows`: network columns through the
    device-path selection, metrics through `evaluate_columns`, on the CPU."""
    cols, topo = _rows_cols(spec, rows)
    nets = ES.network_columns_device(cols, topo, spec.topologies, device="cpu")
    bits = np.asarray([[t.total_bits] for t in traffics])
    xfers = np.asarray([[t.n_transfers] for t in traffics])
    return EC.evaluate_columns(nets, cols, bits, xfers, device="cpu")


def _same_arrays(a: dict, b: dict, what: str) -> None:
    for k in a:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differs bitwise")


def phase_engine_sweep() -> dict:
    """`benchmarks/torch_sweep_bench.py`'s FULL_AXES grid (4096 configs):
    its checks (batched within RTOL 1e-4 of the scalar dataclass loop,
    speedup >= 20x, streamed argmin bitwise), the card against the CPU, and
    `sweep_chunked(MinReducer)` bit-identical to the monolithic sweep's
    argmin for every materialize x prefetch x chunk size."""
    from benchmarks import torch_sweep_bench as sb
    bench = sb.run(csv=False, smoke=False, device="cuda")
    _require_checks({k: bench["checks"][k] for k in bench["required_checks"]},
                    "engine_sweep bench")
    traffic = EC.CNN_WORKLOADS["ResNet18"]().traffic()
    mono = ES.sweep(traffic, topologies=sb.TOPOLOGIES, device="cuda", **sb.FULL_AXES)
    cpu = ES.sweep(traffic, topologies=sb.TOPOLOGIES, device="cpu", **sb.FULL_AXES)
    err = max(_hold(mono.metrics[k], cpu.metrics[k], f"sweep/{k}") for k in mono.metrics)
    energy = mono.metrics["energy_j"]
    i = int(np.argmin(energy))
    n = mono.grid.n
    combos = []
    for mat in ("host", "device"):
        for depth in (0, 1, 2):
            for chunk in (n // 8, 1000):
                best = ES.sweep_chunked(traffic, ES.MinReducer("energy_j"),
                                        topologies=sb.TOPOLOGIES, chunk_size=chunk,
                                        materialize=mat, prefetch=depth, device="cuda",
                                        **sb.FULL_AXES)
                if best["index"] != i or best["value"] != energy[i]:
                    raise AssertionError(f"engine_sweep: streamed argmin ({mat}, prefetch "
                                         f"{depth}, chunk {chunk}) {best['index']} "
                                         f"{best['value']!r} != monolithic {i} {energy[i]!r}")
                combos.append(f"{mat}/{depth}/{chunk}")
    out = {"phase": "engine_sweep", "n_configs": n,
           "scalar_configs_per_s": bench["scalar_configs_per_s"],
           "batched_configs_per_s": bench["batched_configs_per_s"],
           "stream_configs_per_s": bench["pipelined_configs_per_s"],
           "stream_chunk": bench["pipeline_chunk_size"], "speedup": bench["speedup"],
           "batched_vs_scalar_max_rel_err": bench["max_rel_err"],
           "checks": bench["checks"], "max_rel_err_vs_cpu": err,
           "argmin_bitwise": combos, "argmin": {"index": i, "config": mono.config_at(i)}}
    emit(out)
    return out


def _stream(traffics, rows, materialize: str, prefetch: int) -> tuple:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = ES.sweep_chunked(traffics, _MinAndSample("energy_j", rows),
                           topologies=STREAM_TOPOLOGIES, chunk_size=STREAM_CHUNK,
                           materialize=materialize, prefetch=prefetch, device="cuda",
                           **STREAM_AXES)
    seconds = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    return res, seconds, peak


def _stream_chunk_breakdown(spec, traffics) -> dict:
    """One chunk of the stream taken apart, each part timed to its end on
    the host clock: the device decode and evaluation (to a synchronize), the
    copy of its results to the host, and the fold into `MinReducer`.  The
    second of two passes (the first warms the allocator)."""
    xp = TorchNS(DEV)
    bits = xp.asarray(np.asarray([[t.total_bits] for t in traffics]))
    xfers = xp.asarray(np.asarray([[t.n_transfers] for t in traffics]))
    tables = {k: xp.asarray(np.asarray(v, np.float64)) for k, v in spec.axes.items()}
    base = {k: xp.asarray(v) for k, v in spec.base.items()}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cols, topo = ES._decode(spec, STREAM_CHUNK, tables, base, 0, xp.device)
        nets, mets = ES._engine(cols, topo, ES._scenario_inputs(xp), bits, xfers,
                                xp.asarray(1.0), spec.topologies, xp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host_nets, host_mets = ES._to_host(nets), ES._to_host(mets)
        t2 = time.perf_counter()
        ES.MinReducer("energy_j").step(None, ES.SweepChunk(
            spec=spec, start=0, stop=STREAM_CHUNK, topo_id=topo.cpu().numpy(),
            nets=host_nets, metrics=ES.broadcast_metrics(host_mets, np)))
        t3 = time.perf_counter()
    return {"device_ms": (t1 - t0) * 1e3, "to_host_ms": (t2 - t1) * 1e3,
            "fold_ms": (t3 - t2) * 1e3,
            "to_host_mb": sum(v.nbytes for v in (*host_nets.values(), *host_mets.values())) / 1e6}


def phase_engine_stream(seed: int) -> dict:
    """The 9,830,400-configuration grid, six CNN traffics as metric rows,
    streamed through `MinReducer("energy_j")` in chunks of 2^20: device
    materialization at prefetch 2 and 0, host materialization at prefetch
    0, all bit-identical; the winners and 4096 rows drawn from `seed` equal
    the port's CPU evaluation at ENGINE_RTOL."""
    spec = ES.grid_spec(STREAM_TOPOLOGIES, **STREAM_AXES)
    n = spec.n
    traffics = [f().traffic() for f in EC.CNN_WORKLOADS.values()]
    rows = np.random.default_rng(seed).choice(n, STREAM_SAMPLES, replace=False)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    runs = {}
    for mat, depth in (("device", 2), ("device", 0), ("host", 0)):
        res, seconds, peak = _stream(traffics, rows, mat, depth)
        runs[f"{mat}/prefetch{depth}"] = {"seconds": seconds, "configs_per_s": n / seconds,
                                          "device_peak_gb": peak, "res": res}
    ref = runs["device/prefetch2"]["res"]
    for key, r in runs.items():
        res = r.pop("res")
        if not (np.array_equal(res["index"], ref["index"])
                and np.array_equal(res["value"], ref["value"])):
            raise AssertionError(f"engine_stream: {key} minima differ from device/prefetch2")
        _same_arrays(res["sample"], ref["sample"], f"engine_stream {key} samples")
    breakdown = _stream_chunk_breakdown(spec, traffics)
    cpu = _cpu_metrics(spec, np.sort(rows), traffics)
    err = max(_hold(ref["sample"][k], cpu[k], f"stream/{k}") for k in cpu)
    winners = np.asarray(ref["index"])
    cpu_w = _cpu_metrics(spec, winners, traffics)["energy_j"]
    err = max(err, _hold(ref["value"], np.diagonal(cpu_w), "stream/winners"))
    out = {"phase": "engine_stream", "n_configs": n, "traffics": len(traffics),
           "chunk": STREAM_CHUNK, "runs": runs, "one_chunk": breakdown,
           "prefetch0_over_prefetch2": runs["device/prefetch0"]["seconds"]
           / runs["device/prefetch2"]["seconds"],
           "host_max_rss_gb": {"before": rss0,
                               "after": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6},
           "whole_grid_columns_gb": n * len(spec.base) * 8 / 1e9,
           "winners": [{"cnn": name, "index": int(j), "energy_j": float(v),
                        "config": spec.config_at(int(j))}
                       for name, j, v in zip(EC.CNN_WORKLOADS, winners, ref["value"])],
           "sampled_rows": STREAM_SAMPLES, "seed": seed,
           "max_rel_err_vs_cpu": err, "rtol": ENGINE_RTOL}
    emit(out)
    return out


def phase_engine_availability(seed: int) -> dict:
    """`availability_search` over 51,200 configurations under 256 Monte-Carlo
    fault scenarios (1.31e7 evaluations): bit-identical across materialize
    modes and prefetch 0/2; a faulted run under HEALTHY bitwise the plain
    sweep; per-point yields on a window drawn from `seed` equal to the
    CPU's at ENGINE_RTOL."""
    traffic = EC.CNN_WORKLOADS["ResNet18"]().traffic()
    scen = EF.FaultModel(**FAULT_RATES).sample(AVAIL_SCENARIOS, rng=seed)
    budget = 2.0 * float(EF.evaluate_degraded(traffic, EF.HEALTHY, "trine",
                                              device="cuda")["energy_per_bit_j"][0])
    spec = ES.grid_spec(STREAM_TOPOLOGIES, **AVAIL_AXES)
    kw = dict(topologies=STREAM_TOPOLOGIES, epb_budget_j=budget, chunk_size=8192,
              device="cuda", **AVAIL_AXES)
    runs, results = {}, {}
    for mat, depth in (("device", 2), ("device", 0), ("host", 0), ("host", 2)):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        results[(mat, depth)] = EF.availability_search(traffic, scen, materialize=mat,
                                                       prefetch=depth, **kw)
        seconds = time.perf_counter() - t0
        runs[f"{mat}/prefetch{depth}"] = {
            "seconds": seconds, "evaluations_per_s": spec.n * AVAIL_SCENARIOS / seconds,
            "device_peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    ref = results[("device", 2)]
    fields = ("expected_edp", "expected_epb", "availability")
    for key, r in results.items():
        _same_arrays({k: r[k] for k in fields}, ref, f"engine_availability {key}")
        if r["best_survivable"] != ref["best_survivable"]:
            raise AssertionError(f"engine_availability {key}: best_survivable differs")
    plain = ES.sweep(traffic, topologies=STREAM_TOPOLOGIES, device="cuda", **AVAIL_AXES)
    healthy = ES.sweep_chunked(traffic, _Collect(), topologies=STREAM_TOPOLOGIES,
                               chunk_size=8192, columns_fn=EF.faulted_columns_fn(EF.HEALTHY),
                               device="cuda", **AVAIL_AXES)
    _same_arrays(healthy, plain.metrics, "engine_availability faulted HEALTHY vs plain")
    # the CPU's yields on a window of 2048 rows
    w = min(2048, spec.n)
    a = int(np.random.default_rng(seed).integers(0, spec.n - w + 1))
    cols, topo = spec.chunk_cols(a, a + w)
    nets, dcols = EF.degraded_network_columns(cols, topo, spec.topologies, scen)
    mets = EC.evaluate_columns(nets, dcols, traffic.total_bits, traffic.n_transfers,
                               device="cpu")
    red = EF.AvailabilityReducer(budget)
    carry = red.step(red.init(spec), ES.SweepChunk(spec=spec, start=a, stop=a + w,
                                                   topo_id=topo, nets=nets, metrics=mets))
    err = max(_hold(ref[k][a:a + w], carry[k][a:a + w], f"availability/{k}")
              for k in fields)
    avail = ref["availability"]
    out = {"phase": "engine_availability", "n_configs": spec.n,
           "scenarios": AVAIL_SCENARIOS, "evaluations": spec.n * AVAIL_SCENARIOS,
           "fault_rates": FAULT_RATES, "epb_budget_j": budget, "runs": runs,
           "availability": {"min": float(avail.min()), "mean": float(avail.mean()),
                            "max": float(avail.max()),
                            "share_at_least_0.9": float(np.mean(avail >= 0.9))},
           "best_survivable": ref["best_survivable"], "cpu_window": [a, a + w],
           "max_rel_err_vs_cpu": err, "healthy_bitwise_plain": True, "rtol": ENGINE_RTOL}
    emit(out)
    return out


FABRIC_SEVERITIES = (0.25, 0.5, 1.0)
FABRIC_LINK_FIELDS = ("cross_pod_bw_bytes_per_s", "intra_pod_bw_bytes_per_s",
                      "link_latency_s", "energy_per_bit_j")


def phase_engine_fabric(seed: int) -> dict:
    """The fabric layer: the six presets and `Fabric.from_config` on three
    rows of the stream's grid drawn from `seed`, each degraded under
    `resilience_bench`'s BASE_MODEL expected scenarios at severities 0.25,
    0.5 and 1.0 (and HEALTHY) on the card, equal to the port's CPU at
    ENGINE_RTOL; then `benchmarks/torch_resilience_bench.py` in full mode
    on the card, every check True, its curves equal to the CPU's."""
    from benchmarks import torch_resilience_bench as rb
    t_phase = time.perf_counter()
    spec = ES.grid_spec(STREAM_TOPOLOGIES, **STREAM_AXES)
    rows = np.random.default_rng(seed).choice(spec.n, 3, replace=False)
    fabrics = {name: EC.get_fabric(name) for name in EC.FABRIC_PRESETS}
    for i in rows:
        fabrics[f"row{int(i)}"] = EC.Fabric.from_config(spec.config_at(int(i)),
                                                         name=f"row{int(i)}")
    scenarios = [EF.HEALTHY] + [rb.BASE_MODEL.scale(s).expected(name=f"sev{s:g}")
                                for s in FABRIC_SEVERITIES]
    t0 = time.perf_counter()
    card = {(n, sc.name): EC.degrade(fb, sc, device="cuda")
            for n, fb in fabrics.items() for sc in scenarios}
    degrade_s = time.perf_counter() - t0
    err, table = 0.0, {}
    for (n, sname), got in card.items():
        want = EC.degrade(fabrics[n], next(sc for sc in scenarios if sc.name == sname),
                          device="cpu")
        assert got.name == want.name and got.source == want.source, (got, want)
        for f in FABRIC_LINK_FIELDS:
            err = max(err, _hold(getattr(got, f), getattr(want, f), f"fabric/{n}/{sname}/{f}"))
        table.setdefault(n, {})[sname] = {"cross_pod_gbps": got.cross_pod_bw_bytes_per_s / 1e9,
                                          "energy_per_bit_j": got.energy_per_bit_j}
    # the bench in full mode on the card; its cheap views again on the CPU
    bench = rb.run(csv=False, smoke=False, device="cuda")
    _require_checks(bench["checks"], "engine_fabric resilience bench")
    assert bench["yield_grid"]["n_points"] >= 100_000, bench["yield_grid"]
    traffic = EC.CNN_WORKLOADS["ResNet18"]().traffic()
    cpu_curves = rb.degradation_curves(traffic, rb.SEVERITIES_FULL, "cpu")
    cpu_recovery = rb.recovery_rows(rb.SEVERITIES_FULL, "cpu")
    cpu_avail = rb.redundancy_availability(traffic, 256, "cpu")
    for part, cpu_rows in (("degradation", cpu_curves), ("recovery", cpu_recovery)):
        for a, b in zip(bench[part], cpu_rows):
            for k, v in a.items():
                if isinstance(v, float):
                    err = max(err, _hold(v, b[k], f"fabric/bench/{part}/{k}"))
                else:
                    assert v == b[k], (part, k, v, b[k])
    assert bench["availability"] == cpu_avail, (bench["availability"], cpu_avail)
    out = {"phase": "engine_fabric", "seconds": time.perf_counter() - t_phase,
           "fabrics": len(fabrics), "scenarios": len(scenarios),
           "config_rows": [int(i) for i in rows], "degrade_s": degrade_s,
           "degraded": table, "bench_wall_s": bench["wall_s"], "bench_checks": bench["checks"],
           "recovery": bench["recovery"], "availability": bench["availability"],
           "yield_grid": bench["yield_grid"], "max_rel_err_vs_cpu": err, "rtol": ENGINE_RTOL,
           "seed": seed}
    emit(out)
    return out


MASK_SIZES = (1, 17, 5000, 65536)
MASK_BRUTE_MAX = 5000        # the literal O(n^2) brute force up to this size


def _mask_cpu_check(pts: np.ndarray, mask: np.ndarray) -> str:
    """Hold a front mask against the definition on the CPU (numpy): the
    literal O(n^2) brute force (`pareto_mask_reference`) up to
    MASK_BRUTE_MAX points; above it the streamed equivalent — the masked
    points are mutually non-dominated (brute force over them) and every
    other point is dominated by one of them, which by transitivity is the
    brute force's verdict.  Returns which check ran; raises on a
    difference."""
    if pts.shape[0] <= MASK_BRUTE_MAX:
        want = ESR.pareto_mask_reference(pts)
        bad = np.flatnonzero(mask != want)
        assert bad.size == 0, f"pareto_mask differs from the brute force at rows {bad[:8]}"
        return "brute_force"
    front = np.unique(pts[mask], axis=0)      # copies never dominate each other
    assert ESR.pareto_mask_reference(front).all(), "a masked point dominates another"
    rest = pts[~mask]
    for s in range(0, rest.shape[0], 1024):
        p = rest[s:s + 1024, None, :]
        dom = ((front[None] <= p).all(-1) & (front[None] != p).any(-1)).any(1)
        assert dom.all(), f"an unmasked point is not dominated (block at {s})"
    return "front_brute_force_and_dominance"


def _mask_clouds(seed: int):
    """(name, points) clouds from `seed`, for m = 2 and 3 at each of
    MASK_SIZES: normal clouds; coarse integer clouds (ties in every
    objective, exact duplicates) with copies of their first rows appended;
    and "plane" clouds whose front is half the cloud (integer points on the
    plane sum = 40, many copies, the rest above it)."""
    rng = np.random.default_rng(seed)
    for m in (2, 3):
        for n in MASK_SIZES:
            yield f"normal/m{m}/n{n}", rng.normal(size=(n, m))
            ties = rng.integers(0, 6, size=(n, m)).astype(np.float64)
            yield f"ties/m{m}/n{n}", np.concatenate([ties, ties[: max(1, n // 8)]])
            plane = rng.integers(0, 20, size=(n, m)).astype(np.float64)
            on = rng.random(n) < 0.5
            plane[on, -1] = 40.0 - plane[on, :-1].sum(1)
            plane[~on, -1] += 41.0
            yield f"plane/m{m}/n{n}", plane


def _codesign_cpu_points(spec, mixes, wl, indices) -> np.ndarray:
    """The port's CPU evaluation of joint indices (mix * spec.n + row):
    network columns through the engine's selection, the accelerator grid
    on the rows, the objectives of each index's own mix."""
    mix_id, rows = np.divmod(np.asarray(indices, np.int64), spec.n)
    cols, topo = _rows_cols(spec, rows)
    nets = ES.network_columns_device(cols, topo, spec.topologies, device="cpu")
    out = EC.evaluate_accelerator_grid(wl, mixes, nets, cols,
                                       cols["n_mem_chiplets"] * cols["mem_bw_bytes_per_s"],
                                       device="cpu")
    j = np.arange(rows.size)
    return np.stack([out[k][mix_id, j] for k in ESR.ACCEL_OBJECTIVES], -1)


def _codesign_chunk_breakdown(spec, mixes, wl, chunk: int, front) -> dict:
    """One chunk of the co-design stream taken apart, each part timed to its
    end on the host clock: decode, network columns and the accelerator grid
    on the card (to a synchronize), the copy of its objectives to the host,
    and the fold into a running front (the final one).  The second of two
    passes."""
    xp = TorchNS(DEV)
    tables = {k: xp.asarray(np.asarray(v, np.float64)) for k, v in spec.axes.items()}
    base = {k: xp.asarray(v) for k, v in spec.base.items()}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cols, topo = ES._decode(spec, chunk, tables, base, 0, xp.device)
        nets, mem_bw = ES._nets_program(cols, topo, spec.topologies, xp)
        out = EC.evaluate_accelerator_grid(wl, mixes, nets, cols, mem_bw, as_numpy=False,
                                           device=DEV)
        pts_t = torch.stack([out[k] for k in ESR.ACCEL_OBJECTIVES], -1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pts = pts_t.reshape(-1, 3).cpu().numpy()
        t2 = time.perf_counter()
        idx = (np.arange(len(mixes))[:, None] * spec.n + np.arange(chunk)[None]).reshape(-1)
        ESR._merge_into(front, pts, idx, front.objectives, DEV)
        t3 = time.perf_counter()
    total = t3 - t0
    # the same chunk as one CUDA graph (`CodesignChunk`: the bench's chunked
    # path), the second of two calls (the first captures), to a synchronize
    program = CodesignChunk(wl, mixes, spec.topologies, chunk, device=DEV)
    for _ in range(2):
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        program(cols, topo)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
    return {"chunk": chunk, "joint_points": int(pts.shape[0]), "device_ms": (t1 - t0) * 1e3,
            "to_host_ms": (t2 - t1) * 1e3, "fold_ms": (t3 - t2) * 1e3,
            "fold_share": (t3 - t2) / total, "graph_ms": (t5 - t4) * 1e3}


def phase_engine_pareto(seed: int) -> dict:
    """The Pareto/co-design search on the card: `pareto_mask` against the
    definition on the CPU for clouds from `seed`; then
    `benchmarks/torch_pareto_bench.py` in full mode (the 1,105,920-point
    co-design grid) with its front verified exactly against the card's own
    cloud; the streamed network and co-design fronts bit-identical over
    materialize host/device x prefetch 0/2; the co-design front's points
    equal to the port's CPU evaluation of the same indices at ENGINE_RTOL;
    the CPU's co-design front on the smoke grid against the card's (a
    differing index set is printed with its rows' relative gaps); and
    `fabrics_from_front` on the full front."""
    from benchmarks import torch_pareto_bench as pb
    t_phase = time.perf_counter()
    masks = []
    for name, pts in _mask_clouds(seed):
        t0 = time.perf_counter()
        got = ESR.pareto_mask(pts, device="cuda")
        card_s = time.perf_counter() - t0
        check = _mask_cpu_check(pts, got)
        if pts.shape[0] <= MASK_BRUTE_MAX:     # and the port's own CPU path
            assert np.array_equal(got, ESR.pareto_mask(pts, device="cpu")), name
        masks.append({"cloud": name, "n": int(pts.shape[0]), "front": int(got.sum()),
                      "card_s": card_s, "cpu_check": check})

    bench = pb.run(csv=False, smoke=False, device="cuda")
    exact = ("codesign_grid_at_least_1e6", "net_front_streaming_equals_monolithic",
             "net_front_matches_bruteforce", "codesign_front_streaming_equals_monolithic",
             "codesign_front_matches_bruteforce", "codesign_chunk_program_bit_identical",
             "pipeline_modes_bit_identical", "pipeline_grid_at_least_1e6")
    _require_checks({k: bench["checks"][k] for k in exact}, "engine_pareto bench")
    wl = EC.CNN_WORKLOADS["ResNet18"]()
    mixes = pb._mix_library(False)
    spec = ES.grid_spec(pb.TOPOLOGIES, **pb.FULL_NET_AXES)
    cd_idx = np.asarray(bench["codesign"]["front_indices"], np.int64)
    net_idx = np.asarray(bench["network"]["front_indices"], np.int64)
    modes, fronts = {}, {}
    for mat in ("host", "device"):
        for depth in (0, 2):
            t0 = time.perf_counter()
            front, _ = ESR.codesign_pareto(wl, mixes, topologies=pb.TOPOLOGIES,
                                           chunk_size=bench["codesign"]["search_chunk_size"],
                                           materialize=mat, prefetch=depth, device="cuda",
                                           **pb.FULL_NET_AXES)
            seconds = time.perf_counter() - t0
            net = ESR.pareto_search(wl.traffic(), topologies=pb.TOPOLOGIES,
                                    chunk_size=bench["network"]["chunk_size"],
                                    materialize=mat, prefetch=depth, device="cuda",
                                    **pb.FULL_NET_AXES)
            fronts[(mat, depth)] = front
            assert np.array_equal(front.indices, cd_idx), f"co-design front {mat}/{depth}"
            assert np.array_equal(net.indices, net_idx), f"network front {mat}/{depth}"
            modes[f"{mat}/prefetch{depth}"] = {
                "codesign_s": seconds,
                "codesign_points_per_s": bench["codesign"]["n_joint_points"] / seconds}
    ref = fronts[("device", 2)]
    for key, f in fronts.items():
        assert np.array_equal(f.points, ref.points), f"co-design front points {key}"
    cpu_pts = _codesign_cpu_points(spec, mixes, wl, ref.indices)
    err = _hold(ref.points, cpu_pts, "pareto/front_points")
    breakdown = _codesign_chunk_breakdown(spec, mixes, wl,
                                          bench["codesign"]["search_chunk_size"], ref)
    # the CPU's co-design front on the smoke grid against the card's
    small = dict(topologies=pb.TOPOLOGIES, chunk_size=64, **pb.SMOKE_NET_AXES)
    f_card, sspec = ESR.codesign_pareto(wl, mixes, device="cuda", **small)
    f_cpu, _ = ESR.codesign_pareto(wl, mixes, device="cpu", **small)
    differ = sorted(set(f_card.indices.tolist()) ^ set(f_cpu.indices.tolist()))
    gaps = []
    if differ:   # each such row's CPU point, and its gap to the CPU front's nearest other
        for i, p in zip(differ, _codesign_cpu_points(sspec, mixes, wl, differ)):
            others = f_cpu.points[f_cpu.indices != i]
            gaps.append({"index": i, "on_card_front": bool(np.isin(i, f_card.indices)),
                         "point_cpu": p.tolist(), "nearest_rel_gap": float(
                             np.min(np.max(np.abs(others - p) / np.abs(p), axis=1)))})
        print(json.dumps({"engine_pareto_front_differs": gaps}), flush=True)
    common = np.intersect1d(f_card.indices, f_cpu.indices)
    err = max(err, _hold(f_card.points[np.argsort(f_card.indices)][
                             np.isin(np.sort(f_card.indices), common)],
                         f_cpu.points[np.argsort(f_cpu.indices)][
                             np.isin(np.sort(f_cpu.indices), common)],
                         "pareto/smoke_front_points"))
    fabs = EC.fabrics_from_front(ref, spec, mixes=mixes)
    keys = [tuple(sorted(f.source.items())) for f in fabs]
    assert fabs and len(keys) == len(set(keys)), "fabrics_from_front: duplicates"
    on_front = set(cd_idx.tolist())
    assert all(int(f.name.rsplit("@", 1)[1]) in on_front for f in fabs)
    out = {"phase": "engine_pareto", "seconds": time.perf_counter() - t_phase,
           "masks": masks, "bench_checks": bench["checks"],
           "bench_pass": bench["pass"], "network": {k: v for k, v in bench["network"].items()
                                                    if k != "front_indices"},
           "pipeline": bench["pipeline"],
           "codesign": {k: v for k, v in bench["codesign"].items() if k != "front_indices"},
           "modes": modes, "one_chunk": breakdown,
           "codesign_chunked_over_monolithic": bench["codesign"]["chunked_over_monolithic"],
           "codesign_ratio_bar": bench["ratio_bar"],
           "chunk_program": bench["codesign"]["chunk_program"],
           "smoke_grid_front": {"card": f_card.size, "cpu": f_cpu.size,
                                "indices_differ": differ, "gaps": gaps},
           "fabrics": {"n": len(fabs), "names": [f.name for f in fabs[:8]],
                       "cross_pod_gbps": [f.cross_pod_bw_bytes_per_s / 1e9 for f in fabs[:8]]},
           "max_rel_err_vs_cpu": err, "rtol": ENGINE_RTOL, "seed": seed}
    emit(out)
    return out, bench, ref


REFINE_RTOL = 1e-9           # refinement traces and values, card against the CPU
REFINE_TIE_RTOL = 1e-12      # two differing integer designs must score this close
REFINE_CHECKS = ("refinement_improves", "refined_front_dominates_seed",
                 "refined_improves_a_seed", "trust_region_front_dominates_first_order",
                 "trust_region_rescore_bit_identical")


def _kernel_launches(fn) -> int:
    """Device kernels of one call of `fn`, under `torch.profiler` (copies
    and fills left out)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
               and "memcpy" not in e.key.lower() and "memset" not in e.key.lower())


class _RefineMeter:
    """Wraps `search._value_and_grad` and `search._hessian` while it is
    entered: counts and host seconds of each call (each ends in a copy to
    the host, so its seconds include the device's work).  The first card
    call of each is kept, to count its launches under the profiler once
    every timed run is over (`launches`): a profiler, once started, slows
    every later launch in the process."""

    def __init__(self):
        self.stats = {"vg_calls": 0, "vg_s": 0.0, "hess_calls": 0, "hess_s": 0.0}
        self.first = {}

    def _wrap(self, make, key):
        def wrapped(loss_of, dev):
            f = make(loss_of, dev)

            def timed(theta):
                if dev.type == "cuda" and key not in self.first:
                    self.first[key] = (f, np.array(theta, np.float64))
                t0 = time.perf_counter()
                out = f(theta)
                self.stats[f"{key}_s"] += time.perf_counter() - t0
                self.stats[f"{key}_calls"] += 1
                return out
            return timed
        return wrapped

    def __enter__(self):
        self._saved = ESR._value_and_grad, ESR._hessian
        ESR._value_and_grad = self._wrap(self._saved[0], "vg")
        ESR._hessian = self._wrap(self._saved[1], "hess")
        return self

    def __exit__(self, *exc):
        ESR._value_and_grad, ESR._hessian = self._saved

    def launches(self) -> dict:
        return {key: _kernel_launches(lambda: f(theta))
                for key, (f, theta) in self.first.items()}

    def summary(self, seconds: float, iterations: int) -> dict:
        st = self.stats
        per = {k: (st[f"{k}_s"] / st[f"{k}_calls"] * 1e3 if st[f"{k}_calls"] else None)
               for k in ("vg", "hess")}
        out = {"seconds": seconds, "iterations": iterations,
               "iterations_per_s": iterations / seconds, **st,
               "vg_ms": per["vg"], "hess_ms": per["hess"],
               "engine_share": (st["vg_s"] + st["hess_s"]) / seconds}
        if st["hess_calls"]:
            out["hessian_share_of_step"] = per["hess"] / (per["hess"] + per["vg"])
            out["hessian_share_of_call"] = st["hess_s"] / seconds
        return out


def _iterations(results) -> int:
    """Descent iterations of `refine_codesign` results: first order, its
    steps (each one value-and-gradient call, plus the closing one); trust
    region, its accepted and rejected steps."""
    return sum(len(r["tr_stats"]["radius_trace"]) if r["tr_stats"] else len(r["loss_trace"]) - 1
               for r in results)


def _score_design(r, spec, workloads, device) -> float:
    """The exact scalarized score of a refined design on `device` (log of
    the weighted-geomean EDP, as the refiner ranks designs)."""
    from benchmarks import torch_pareto_bench as pb
    per = pb.design_metrics(r, spec, workloads, device)
    return sum(wt * float(np.log(m["energy_j"] * m["latency_s"]))
               for wt, m in zip(r["weights"], per))


def _hold_refine(card, cpu, spec, workloads, what: str) -> dict:
    """One `refine_codesign` result on the card against the CPU's on the
    same seed: counts exactly, traces, relaxed values, sensitivities
    (against the vector's scale: a flat axis's gradient is rounding noise)
    and values at REFINE_RTOL.  A differing integer design is printed with
    both devices' exact scores of both designs, and fails unless they tie
    within REFINE_TIE_RTOL."""
    what = f"{what}@{card['flat_index']}"
    design = [(c.n_units, c.vector_size) for c in card["refined"]["chiplets"]]
    design_cpu = [(c.n_units, c.vector_size) for c in cpu["refined"]["chiplets"]]
    cfg_card = {k: v for k, v in card["refined"]["config"].items() if k != "chiplets"}
    cfg_cpu = {k: v for k, v in cpu["refined"]["config"].items() if k != "chiplets"}
    same = design == design_cpu and _max_rel(
        [v for v in cfg_card.values() if not isinstance(v, str)],
        [v for v in cfg_cpu.values() if not isinstance(v, str)]) <= REFINE_RTOL
    out = {"seed": card["flat_index"], "same_design": same, "design": design,
           "improvement": card["improvement"], "n_candidates": card["n_candidates"]}
    if not same:          # printed before any check can stop the run
        scores = {dev: {"card_design": _score_design(card, spec, workloads, dev),
                        "cpu_design": _score_design(cpu, spec, workloads, dev)}
                  for dev in ("cuda", "cpu")}
        print(json.dumps({"engine_refine_design_differs": what, "card": design,
                          "cpu": design_cpu,
                          "card_config": {k: str(v) for k, v in cfg_card.items()},
                          "cpu_config": {k: str(v) for k, v in cfg_cpu.items()},
                          "log_scores": scores, "relaxed_card": card["relaxed"],
                          "relaxed_cpu": cpu["relaxed"]}), flush=True)
        out["tie"] = scores
    assert card["n_candidates"] == cpu["n_candidates"], f"{what}: n_candidates"
    if card["tr_stats"] is not None:
        for k in ("accepted", "rejected"):
            assert card["tr_stats"][k] == cpu["tr_stats"][k], f"{what}: tr {k}"
        for k in ("n_scored", "n_sweeps"):
            assert card["line_search"][k] == cpu["line_search"][k], f"{what}: line search {k}"
    err = _hold(card["loss_trace"], cpu["loss_trace"], f"{what}/loss_trace", REFINE_RTOL)
    err = max(err, _hold(list(card["relaxed"].values()), list(cpu["relaxed"].values()),
                         f"{what}/relaxed", REFINE_RTOL))
    sc = np.asarray(list(card["sensitivity"].values()))
    sp = np.asarray(list(cpu["sensitivity"].values()))
    scale = float(np.abs(sp).max(initial=0.0))
    sens_err = float(np.max(np.abs(sc - sp), initial=0.0)) / scale if scale else 0.0
    assert sens_err <= REFINE_RTOL, f"{what}: sensitivity err {sens_err:.3e}"
    out["sensitivity_err"] = sens_err
    if same:
        err = max(err, _hold(card["refined"]["value"], cpu["refined"]["value"],
                             f"{what}/value", REFINE_RTOL))
    else:
        for dev, sc2 in out["tie"].items():
            gap = abs(sc2["card_design"] - sc2["cpu_design"]) / abs(sc2["cpu_design"])
            assert gap <= REFINE_TIE_RTOL, \
                f"{what}: designs differ and do not tie on {dev} ({gap:.3e})"
    out["max_rel_err"] = err
    return out


def _example_on_card() -> dict:
    """`examples/torch_photonic_design_space.py` in smoke mode on the card,
    in its own process: its seconds and that every section printed."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, REPRO_SMOKE="1",
               PYTHONPATH=os.pathsep.join([str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, str(root / "examples/torch_photonic_design_space.py")],
                       env=env, capture_output=True, text=True, timeout=600, cwd=root)
    seconds = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"the design-space example failed: {p.stderr[-2000:]}")
    sections = ("K-sweep", "WDM sweep", "Device sensitivity", "Full design-space search",
                "Streaming Pareto search", "Gradient refinement (autograd",
                "Co-design search", "Co-design refinement", "Six-CNN joint refinement",
                "Fabric what-if")
    missing = [x for x in sections if x not in p.stdout]
    assert not missing, f"the design-space example did not print {missing}"
    return {"seconds": seconds, "lines": len(p.stdout.splitlines()),
            "refined_lines": [ln.strip() for ln in p.stdout.splitlines()
                              if "->" in ln and "EDP" in ln][:4]}


def phase_engine_refine(bench: dict, front) -> dict:
    """The refinement engines on the card: `torch_pareto_bench`'s refine
    sections in full mode (`engine_pareto` ran them) with every refine
    check True; then, on the full co-design front's best-EDP seeds, each
    refine call timed on the card and on the CPU (`refine_front_point`,
    48 steps; `refine_front` first order, top 3 x 32 steps, ResNet18; and
    trust region, top 3 x 32 steps, the bench's 3-CNN batch), its steps a
    second, the launches of one value-and-gradient call and of one Hessian,
    the Hessian's share of a trust-region step, and the card held against
    the CPU (`_hold_refine`); then the design-space example in smoke mode."""
    from benchmarks import torch_pareto_bench as pb
    t_phase = time.perf_counter()
    _require_checks({k: bench["checks"][k] for k in REFINE_CHECKS}, "engine_refine bench")
    wl = EC.CNN_WORKLOADS["ResNet18"]()
    mixes = pb._mix_library(False)
    spec = ES.grid_spec(pb.TOPOLOGIES, **pb.FULL_NET_AXES)
    row = bench["codesign"]["best_edp_index"] % spec.n
    tr_wls = [wl] + [EC.CNN_WORKLOADS[n]() for n in pb.TR_WORKLOADS]
    calls = {
        "refine_front_point": lambda dev: ESR.refine_front_point(
            spec, wl.traffic(), row, steps=48, lr=0.1, device=dev),
        "first_order": lambda dev: ESR.refine_front(
            front, spec, mixes, wl, top_k=3, steps=32, lr=0.1, device=dev),
        "trust_region": lambda dev: ESR.refine_front(
            front, spec, mixes, tr_wls, top_k=3, method="trust_region",
            refine_axes=pb.TR_AXES, steps=32, device=dev),
    }
    out = {"phase": "engine_refine", "bench": {
        "checks": {k: bench["checks"][k] for k in REFINE_CHECKS},
        "refine": bench["refine"], "refined_front": bench["refined_front"],
        "trust_region_front": bench["trust_region_front"],
        "codesign_refine_s": bench["codesign"]["refine_s"]}}
    err, meters = 0.0, {}
    for name, call in calls.items():
        res = {}
        for dev in ("cuda", "cpu"):
            with _RefineMeter() as meter:
                t0 = time.perf_counter()
                r = call(dev)
                seconds = time.perf_counter() - t0
            results = r["results"] if "results" in r else []
            iters = _iterations(results) if results else len(r["loss_trace"]) - 1
            res[dev] = (r, meter.summary(seconds, iters))
            if dev == "cuda":
                meters[name] = meter
        (card, m_card), (cpu, m_cpu) = res["cuda"], res["cpu"]
        entry = {"card": m_card, "cpu": m_cpu}
        if name == "refine_front_point":
            err = max(err, _hold(card["loss_trace"], cpu["loss_trace"], "refine/loss_trace",
                                 REFINE_RTOL))
            err = max(err, _hold(list(card["refined"].values()), list(cpu["refined"].values()),
                                 "refine/refined", REFINE_RTOL))
            err = max(err, _hold([card["metrics"][k] for k in cpu["metrics"]],
                                 list(cpu["metrics"].values()), "refine/metrics", REFINE_RTOL))
            entry["improvement"] = card["improvement"]
        else:
            wls = tr_wls if name == "trust_region" else [wl]
            held = [_hold_refine(a, b, spec, wls, name)
                    for a, b in zip(card["results"], cpu["results"])]
            err = max([err] + [h["max_rel_err"] for h in held])
            entry.update(seeds=held, n_improved=card["n_improved"],
                         front_sizes=[card["seed_front"].size, card["front"].size])
            if all(h["same_design"] for h in held):
                assert np.array_equal(card["front"].indices, cpu["front"].indices), name
        out[name] = entry
    out["example_smoke"] = _example_on_card()
    for name, meter in meters.items():          # after every timed run
        out[name]["card"]["launches"] = meter.launches()
    out.update(max_rel_err_vs_cpu=err, rtol=REFINE_RTOL,
               seconds=time.perf_counter() - t_phase)
    emit(out)
    return out


def _hold_tree(got, want, what: str, rtol: float = ENGINE_RTOL) -> float:
    """A bench's output on the card against the CPU's: every float at
    `rtol` (`_hold`), every other field equal.  Returns the worst relative
    error."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got) ^ set(want))
        return max([0.0] + [_hold_tree(got[k], want[k], f"{what}/{k}", rtol) for k in want])
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), (what, len(got), len(want))
        return max([0.0] + [_hold_tree(a, b, f"{what}[{i}]", rtol)
                            for i, (a, b) in enumerate(zip(got, want))])
    if isinstance(want, float) and not isinstance(want, bool):
        return _hold(got, want, what, rtol)
    assert got == want, (what, got, want)
    return 0.0


def phase_engine_whatif() -> dict:
    """The benchmarks that price LM steps over photonic fabrics:
    `benchmarks/torch_fabric_whatif.py` in full mode (its co-design frontier
    searched on the device; every check True; the ranking, every cell's
    bottleneck under every fabric, and every results row equal to the CPU
    run's at ENGINE_RTOL) and `torch_roofline.py` (its photonic roofline on
    the device, equal to the CPU's), each on the card and on the CPU; then
    `torch_collectives_bench.py`, host arithmetic that runs on no device,
    once.  Seconds of each."""
    from benchmarks import torch_collectives_bench as cb
    from benchmarks import torch_fabric_whatif as wb
    from benchmarks import torch_roofline as rb
    t_phase = time.perf_counter()
    out = {"phase": "engine_whatif"}
    err = 0.0
    for name, run in (("fabric_whatif", lambda dev: wb.run(csv=False, smoke=False, device=dev)),
                      ("roofline", lambda dev: rb.run(csv=False, device=dev))):
        res, seconds = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res[dev] = run(dev)
            seconds[dev] = time.perf_counter() - t0
        card, cpu = res["cuda"], res["cpu"]
        entry = {"card_s": seconds["cuda"], "cpu_s": seconds["cpu"]}
        if name == "fabric_whatif":
            _require_checks(card["checks"], "engine_whatif fabric_whatif")
            base = {(r["arch"], r["shape"]): r["bottleneck"] for r in card["results"]
                    if r["fabric"] == "metallic_ici"}
            flips = [(r["arch"], r["shape"], r["fabric"], base[(r["arch"], r["shape"])],
                      r["bottleneck"])
                     for r in card["results"] if r["bottleneck"] != base[(r["arch"], r["shape"])]]
            entry.update(checks=card["checks"], n_fabrics=len(card["fabrics"]),
                         n_cells=len(card["cells"]), edp_front_size=card["edp_front_size"],
                         ranking=[r["fabric"] for r in card["ranking"]],
                         frontier_ranking=card["frontier_ranking"], bottleneck_flips=flips)
            card = {k: v for k, v in card.items() if k != "elapsed_s"}
            cpu = {k: v for k, v in cpu.items() if k != "elapsed_s"}
        else:
            entry.update(n_ok=card["n_ok"], photonic_rows=len(card["photonic"]))
        entry["max_rel_err_vs_cpu"] = _hold_tree(card, cpu, f"whatif/{name}")
        err = max(err, entry["max_rel_err_vs_cpu"])
        out[name] = entry
    t0 = time.perf_counter()
    rows = cb.run(csv=False)["rows"]
    out["collectives"] = {"host_s": time.perf_counter() - t0, "rows": len(rows)}
    assert len(rows) == len(cb.GRAD_SIZES), rows
    out.update(max_rel_err_vs_cpu=err, rtol=ENGINE_RTOL, seconds=time.perf_counter() - t_phase)
    emit(out)
    return out


def run_engine(seed: int) -> dict:
    """The engine phases, in order; any failed check raises."""
    out = {"engine_fig4": phase_engine_fig4(), "engine_fig6": phase_engine_fig6(),
           "engine_sweep": phase_engine_sweep(), "engine_stream": phase_engine_stream(seed),
           "engine_availability": phase_engine_availability(seed),
           "engine_fabric": phase_engine_fabric(seed)}
    out["engine_pareto"], bench, front = phase_engine_pareto(seed)
    out["engine_refine"] = phase_engine_refine(bench, front)
    out["engine_whatif"] = phase_engine_whatif()
    return out


# ---------------------------------------------------------------------------
# the serving paths at full width and depth
# ---------------------------------------------------------------------------


def counters() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def zero_counters() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _since(before: dict) -> dict:
    return {name: n - before[name] for name, n in counters().items()}


def block_linears(cfg, kind: str) -> list:
    """(K, N, rows) of every product one block of `kind` runs through
    `layers.linear`, from `models/layers.py`: rows "x" are the block's own
    (batch x length), rows "enc" the encoder's output's (batch x frames)."""
    m, f = cfg.d_model, cfg.d_ff
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    attn = [(m, h * dh, "x"), (m, hk * dh, "x"), (m, hk * dh, "x"), (h * dh, m, "x")]
    mlp = [(m, f, "x"), (m, f, "x"), (f, m, "x")]                       # wg, wi, mlp wo
    if kind == "dec":     # self-attention; cross-attention, K/V from the encoder; MLP
        return attn + [(m, h * dh, "x"), (m, hk * dh, "enc"), (m, hk * dh, "enc"),
                       (h * dh, m, "x")] + mlp
    if kind in ATTN_KINDS:                                              # wq, wk, wv, wo
        if kind == "moe":       # the router; the experts are plain products
            return attn + [(m, cfg.n_experts, "x")]
        return attn + (mlp if kind != "shared_attn" and f else [])      # shared_attn: no MLP
    if kind == "mamba":   # in_proj [z, x, B, C, dt], out_proj; no MLP
        return [(m, 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads, "x"),
                (cfg.d_inner, m, "x")]
    if kind == "mlstm":   # wqkv, wif, wo
        return [(m, 3 * h * dh, "x"), (m, 2 * h, "x"), (h * dh, m, "x")]
    if kind == "slstm":   # wx, wo (the recurrent h @ wr is a plain product)
        return [(m, 4 * m, "x"), (m, m, "x")]
    raise ValueError(kind)


def _stage_launches(cfg, layout, batch: int, seq: int, frames: int) -> dict:
    """Launches of the blocks of `layout` ((repeat, kinds) stages) on
    `batch` x `seq` rows, attending to `frames` encoder frames."""
    rows = {"x": batch * seq, "enc": batch * frames}
    n = {"photonic_mac": 0, "flash_attention": 0, "ssm_scan": 0}
    for repeat, kinds in layout:
        for kind in kinds:
            n["photonic_mac"] += repeat * sum(ops.uses_tiled_path(rows[r], k, nn)
                                              for k, nn, r in block_linears(cfg, kind))
            if seq > 1 and kind in ATTN_KINDS:     # decode attends by the plain version
                n["flash_attention"] += repeat * int(ops.uses_flash_kernel(seq, seq, 0))
            if kind == "dec":                      # cross-attention, decode included
                n["flash_attention"] += repeat * int(ops.uses_flash_kernel(seq, frames, 0))
            if seq > 1 and kind in ("mamba", "mlstm"):
                n["ssm_scan"] += repeat * (2 if kind == "mlstm" else 1) * int(
                    ops.uses_ssm_kernel(seq))
    return n


def encode_launches(cfg, batch: int, frames: int) -> dict:
    """Launches of one `model.encode` call on `batch` x `frames` frames."""
    return _stage_launches(cfg, [(cfg.encoder_layers, ("enc",))], batch, frames, 0)


def expected_launches(cfg, batch: int, seq: int, frames: int = 0) -> dict:
    """Launches of each kernel in one prefill (seq > 1) or decode step
    (seq == 1) call of `batch` rows, against `frames` encoder frames for an
    encoder-decoder config, from the dispatch predicates in
    `kernels/ops.py`: a linear launches `photonic_mac` when its product
    tiles, an attention (or cross-attention) `flash_attention` and a mamba
    block `ssm_scan` (an mLSTM block two, numerator and normaliser) when the
    lengths pass theirs.  Decode runs no self-attention or scan kernel; a
    prefill of an encoder-decoder config runs the encoder first."""
    n = _stage_launches(cfg, M.stages(cfg), batch, seq, frames)
    if seq > 1 and cfg.encoder_layers:
        n = _add(n, encode_launches(cfg, batch, frames))
    n["photonic_mac"] += int(ops.uses_tiled_path(batch, cfg.d_model, cfg.vocab))  # the head
    return n


def _add(total: dict, part: dict) -> dict:
    return {k: total[k] + part[k] for k in total}


def layout_window(cfg) -> int:
    """The window the blocks of `cfg`'s layout attend within (0: none).
    Keyed on the kinds `M.stages` builds, not on `cfg.window`: gemma3-27b
    sets a window, but as published (family "dense") its `attn` blocks take
    none, as the reference builds them."""
    return max((M._kind_window(cfg, kind) for _, kinds in M.stages(cfg) for kind in kinds),
               default=0)


def _drive_batcher(cfg, params, lengths, max_news, max_len, bucket, fabric=None,
                   **run_kw) -> tuple:
    """Ragged requests churn through 4 slots of the `ContinuousBatcher`
    (with `fabric`, its modelled fabric; `run_kw` go to `run`); the launch
    counts must equal `expected_launches` for its prefills and decode steps.
    Returns (batcher, requests, wall seconds, launches, prefill lengths)."""
    n_slots = 4
    rng = torch.Generator()
    rng.manual_seed(SEED + 1)
    prompts = [torch.randint(2, cfg.vocab, (n,), generator=rng).tolist() for n in lengths]

    before = counters()
    eng = ContinuousBatcher(cfg, params, n_slots=n_slots, max_len=max_len,
                            prompt_bucket=bucket, fabric=fabric, device=DEV)
    reqs = [eng.submit(p, mn) for p, mn in zip(prompts, max_news)]
    t0 = time.perf_counter()
    finished = eng.run(**run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    assert len(finished) == len(reqs) and all(r.done for r in reqs), "requests left unfinished"
    for r, mn in zip(reqs, max_news):
        assert len(r.out) == mn, (r.rid, len(r.out), mn)
        assert all(0 <= t < cfg.vocab for t in r.out), "token id out of range"
    want = {k: 0 for k in KERNELS}
    plens = []
    for n in lengths:
        plen = max(eng.bucket, -(-(n - 1) // eng.bucket) * eng.bucket)
        plens.append(plen)
        want = _add(want, expected_launches(cfg, 1, plen))
    for _ in range(eng.stats["decode_iters"]):
        want = _add(want, expected_launches(cfg, n_slots, 1))
    got = _since(before)
    assert got == want, f"launch counts {got} differ from the code's {want}"
    return eng, reqs, wall, got, plens


def phase_serve_continuous(cfg, params, lengths, max_news, max_len, bucket=128) -> dict:
    """Ragged requests churn through 4 slots of the `ContinuousBatcher`;
    prompts are padded to `bucket`, or prefilled at exact length for the
    recurrent families (the engine's own rule)."""
    eng, reqs, wall, got, plens = _drive_batcher(cfg, params, lengths, max_news, max_len,
                                                 bucket)
    # one more decode step by hand to look at the logits themselves
    logits, _ = M.serve_step(cfg, params, eng.cache, eng.last_tok[:, None], eng.pos, device=DEV)
    assert tuple(logits.shape) == (eng.n_slots, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    st = eng.stats
    out = {"phase": "serve_continuous", "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "dtype": cfg.dtype,
           "n_slots": eng.n_slots, "max_len": max_len, "prompt_bucket": eng.bucket,
           "requests": len(reqs), "prompt_lengths": lengths, "prefill_lengths": plens,
           "max_new": max_news,
           "prefill_calls": st["prefill_calls"], "prefill_tokens": st["prefill_tokens"],
           "prefill_s": st["prefill_s"], "prefill_tokens_per_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_iters": st["decode_iters"], "decode_tokens": st["decode_tokens"],
           "decode_s": st["decode_s"], "decode_tokens_per_s": st["decode_tokens"] / st["decode_s"],
           "wall_s": wall, "launches": got, "sample": reqs[0].out,
           "tokens": [r.out for r in reqs]}
    emit(out)
    return out


# the fault the serving and training fabric phases inject: the expected
# scenario of `benchmarks/torch_resilience_bench.py`'s BASE_MODEL at severity 1
FABRIC_PRESET = "trine_siph"
FAULT_ITER, FAULT_STEP = 3, 3


def _fault_scenario():
    from benchmarks.torch_resilience_bench import BASE_MODEL
    return BASE_MODEL.scale(1.0).expected(name="sev1")


def phase_serve_fabric(cfg, params, lengths, max_news, max_len, continuous: dict,
                       bucket=128) -> dict:
    """`serve_continuous`'s requests again through a batcher that models the
    `FABRIC_PRESET` fabric, the BASE_MODEL severity-1 fault injected before
    decode iteration `FAULT_ITER`: the tokens must equal
    `serve_continuous`'s request for request (the model changes no
    numerics), the replans, fault iteration and channel plans the CPU's,
    and the modelled network seconds the CPU's at ENGINE_RTOL."""
    scen = _fault_scenario()
    eng, reqs, wall, got, _ = _drive_batcher(cfg, params, lengths, max_news, max_len, bucket,
                                             fabric=FABRIC_PRESET, fault_at_iter=FAULT_ITER,
                                             fault_scenario=scen)
    tokens = [r.out for r in reqs]
    differ = [i for i, (a, b) in enumerate(zip(tokens, continuous["tokens"])) if a != b]
    assert not differ, f"serve_fabric: requests {differ} differ from serve_continuous's tokens"
    # the CPU's plan: the same fabric degraded on the host, the same sums
    healthy = EC.get_fabric(FABRIC_PRESET)
    degraded = EC.degrade(healthy, scen, device="cpu")
    # two all-reduces of the bf16 activations of every slot per layer
    wire = float(cfg.n_layers * 2 * eng.n_slots * cfg.d_model * 2)
    plans = [EC.plan_collective_channels(wire, eng.decode_window_s, fabric=fb,
                                         min_chunk_bytes=1 << 10) for fb in (healthy, degraded)]
    per_iter = [fb.collective_s(wire, n_collectives=cfg.n_layers * 2) for fb in (healthy, degraded)]
    net_cpu = 0.0
    for i in range(eng.net_stats["decode_iters"]):
        net_cpu += per_iter[int(i >= FAULT_ITER)]
    ns = eng.net_stats
    assert (ns["replans"], ns["fault_iter"]) == (2, FAULT_ITER), ns
    assert eng.collective_channels == plans[1], (eng.collective_channels, plans)
    assert ns["decode_iters"] == eng.stats["decode_iters"]
    err = _hold(ns["modeled_net_s"], net_cpu, "serve_fabric/modeled_net_s")
    card_fb = EC.degrade(healthy, scen, device="cuda")
    for f in ("cross_pod_bw_bytes_per_s", "intra_pod_bw_bytes_per_s", "link_latency_s",
              "energy_per_bit_j"):
        err = max(err, _hold(getattr(eng.fabric, f), getattr(degraded, f), f"serve_fabric/{f}"))
        assert getattr(eng.fabric, f) == getattr(card_fb, f), f
    out = {"phase": "serve_fabric", "model": cfg.name, "fabric": eng.fabric.name,
           "fault": dataclasses.asdict(scen), "fault_iter": ns["fault_iter"],
           "replans": ns["replans"], "decode_iters": ns["decode_iters"],
           "collective_channels": {"healthy": plans[0], "degraded": eng.collective_channels},
           "modeled_net_s": ns["modeled_net_s"], "modeled_net_s_cpu": net_cpu,
           "modeled_net_s_per_iter": {"healthy": per_iter[0], "degraded": per_iter[1]},
           "cross_pod_gbps": {"healthy": healthy.cross_pod_bw_bytes_per_s / 1e9,
                              "degraded": eng.fabric.cross_pod_bw_bytes_per_s / 1e9},
           "energy_per_bit_j": {"healthy": healthy.energy_per_bit_j,
                                "degraded": eng.fabric.energy_per_bit_j},
           "decode_s": eng.stats["decode_s"], "wall_s": wall, "launches": got,
           "tokens_equal_serve_continuous": True, "max_rel_err_vs_cpu": err,
           "rtol": ENGINE_RTOL}
    emit(out)
    return out


def phase_serve_batch128(cfg, params, arch: str) -> dict:
    """`launch/serve.main` at batch 128 x prompt 128, 4 new tokens; an
    encoder-decoder config against the launcher's S // 4 = 32 frames,
    encoded once for the decode steps and once in the prefill."""
    batch, plen, max_new = 128, 128, 4
    frames = max(1, plen // 4) if cfg.encoder_layers else 0
    torch.cuda.reset_peak_memory_stats()
    before = counters()
    res = serve.main(["--arch", arch, "--batch", str(batch), "--prompt-len", str(plen),
                      "--max-new", str(max_new), "--seed", str(SEED), "--photonic", "--kernels"],
                     params=params, cfg=cfg)
    got = _since(before)
    pf = expected_launches(cfg, batch, plen, frames)
    per_step = expected_launches(cfg, batch, 1, frames)
    if cfg.family in ("dense", "vlm"):    # every linear of yi-6b and qwen2-vl tiles
        assert per_step["photonic_mac"] == cfg.n_layers * 7 + 1, per_step
    want = _add(pf, encode_launches(cfg, batch, frames)) if frames else pf
    for _ in range(max_new - 1):
        want = _add(want, per_step)
    assert got == want, f"launch counts {got} differ from {want}"
    toks, logits = res["tokens"], res["logits"]
    assert tuple(toks.shape) == (batch, max_new)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    assert tuple(logits.shape) == (batch, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    out = {"phase": "serve_batch128", "model": cfg.name, "batch": batch, "prompt_len": plen,
           "encoder_frames": frames, "max_new": max_new, "prefill_s": res["prefill_s"],
           "prefill_tokens_per_s": res["prefill_tokens"] / res["prefill_s"],
           "decode_s": res["decode_s"], "decode_steps": max_new - 1,
           "decode_tokens_per_s": res["decode_tokens"] / res["decode_s"],
           "launches": got, "launches_per_prefill": pf, "launches_per_decode_step": per_step,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card_memory_gb": torch.cuda.get_device_properties(DEV).total_memory / 1e9}
    emit(out)
    return out


def phase_long_prefill(cfg, params, seq: int = 4096) -> dict:
    """One B=1 prefill of `seq` tokens, then one decode step (zamba2: its
    shared attention's whole window, the scan carrying its state through
    seq/128 chunks in sequence; mixtral: past its window, so the prefill
    keeps the last `window` positions and the decode step rolls them)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 4)
    toks = torch.randint(2, cfg.vocab, (1, seq), generator=gen, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    before = counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, {"tokens": toks}, device=DEV)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got, want = _since(before), expected_launches(cfg, 1, seq)
    assert got == want, f"launch counts {got} differ from {want}"
    assert tuple(logits.shape) == (1, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    kv_len = next(c["k"].shape[3] for st in cache for c in st.values() if "k" in c)
    window = layout_window(cfg)
    if window and seq > window:
        assert kv_len == window, (kv_len, window)
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    step, _ = M.serve_step(cfg, params, cache, nxt, seq, device=DEV)
    assert bool(torch.isfinite(step).all())
    out = {"phase": "long_prefill", "model": cfg.name, "batch": 1, "prompt_len": seq,
           "kv_cache_positions": kv_len, "decode_step_rolls": seq >= kv_len,
           "prefill_s": dt, "prefill_tokens_per_s": seq / dt, "launches": got,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    return out


def phase_long_encoder(cfg, params, seq: int = 128, frames: int = 1024) -> dict:
    """B=1: a `seq`-token decoder prompt against `frames` encoder frames (the
    encoder's attention over frames x frames with no mask, the decoder's
    cross-attention seq x frames), then the encoder once more for the
    decode step's `enc_out`, and one decode step."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 5)
    batch = model_inputs(cfg, gen, 1, seq, frames)
    torch.cuda.reset_peak_memory_stats()
    before = counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, batch, device=DEV)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    got, want = _since(before), expected_launches(cfg, 1, seq, frames)
    assert got == want, f"prefill launch counts {got} differ from {want}"
    assert tuple(logits.shape) == (1, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    before = counters()
    t0 = time.perf_counter()
    enc_out = M.encode(cfg, params, batch["enc_embeds"], device=DEV)
    torch.cuda.synchronize()
    t_encode = time.perf_counter() - t0
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    step, _ = M.serve_step(cfg, params, cache, nxt, seq, enc_out=enc_out, device=DEV)
    assert bool(torch.isfinite(step).all())
    got_step = _since(before)
    want_step = _add(encode_launches(cfg, 1, frames), expected_launches(cfg, 1, 1, frames))
    assert got_step == want_step, f"encode + decode launch counts {got_step} differ from {want_step}"
    out = {"phase": "long_encoder", "model": cfg.name, "batch": 1, "prompt_len": seq,
           "encoder_frames": frames, "prefill_s": t_prefill,
           "prefill_tokens_per_s": seq / t_prefill, "encode_s": t_encode,
           "encode_frames_per_s": frames / t_encode, "launches": _add(got, got_step),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    return out


E2E_TOLERANCE = {
    # (compute dtype of the check, tolerance relative to the largest logit).
    # yi-6b: bf16 activations are rounded after every linear, so the kernel
    # and plain runs drift apart by bf16 rounding over 32 layers.
    # zamba2, xlstm: checked in f32.  At random initialisation these networks
    # amplify any perturbation layer by layer (tools/torch_perturbation_growth.py:
    # at zamba2's full width a 1e-3 change of the embeddings moves the last
    # hidden state by 1e-2 after 2 layers and 7e-2 after 13), so in bf16 two orders of
    # summation, and the plain chunked scan's own bf16 roundings, decorrelate
    # the logits before the last layer.  In f32 the kernels and their plain
    # versions differ by about 1e-6 per operation, which the depth grows to
    # well under the tolerance.  The bf16 difference is measured and printed.
    # mixtral: checked in f32.  Routing is a discontinuous function of the
    # router logits, and bf16 logits tie often, so in bf16 one expert choice
    # flipped by the order of a sum decorrelates the logits.
    # seamless, qwen2-vl: dense, no routing or recurrence, so yi-6b's bf16
    # check.
    # yi-34b, deepseek-67b, gemma3-27b: dense attention and MLP blocks like
    # yi-6b's, with no routing or recurrence to turn a rounding into a
    # different path, so the serving dtype, bf16, at yi-6b's tolerance
    # (gemma3 also as published, 5:1 local:global, at 2048 tokens: `E2E_LONG`).
    # grok-1: routed like mixtral (8 experts, top 2), so mixtral's f32 check,
    # and in bf16 the routing flips and the logits with the plain run's
    # choices (`_routing_flips`).
    "yi-6b": ("bfloat16", 3e-2), "zamba2-1.2b": ("float32", 2e-2),
    "xlstm-350m": ("float32", 2e-2), "mixtral-8x7b": ("float32", 2e-2),
    "seamless-m4t-medium": ("bfloat16", 3e-2), "qwen2-vl-72b": ("bfloat16", 3e-2),
    "yi-34b": ("bfloat16", 3e-2), "deepseek-67b": ("bfloat16", 3e-2),
    "gemma3-27b": ("bfloat16", 3e-2), "grok-1-314b": ("float32", 2e-2),
}
# the dense models whose bf16 check also runs in f32, held at mixtral's f32
# tolerance with the same argmax: at yi-34b's 32 layers and gemma3-27b's 40
# the bf16 kernels-vs-plain gap is as large as the plain run's top-2 gap, so
# a bf16 argmax flip needs a witness that tells rounding from a fault
E2E_F32_WITNESS = ("yi-34b", "deepseek-67b", "gemma3-27b")
# the vision end-to-end check's image: an 8 x 8 grid of patch embeddings
PATCH_GRID = 8


def model_inputs(cfg, gen, b: int, s: int, frames: int = 0) -> dict:
    """A batch of `b` x `s` token ids, with `frames` encoder frames (B, frames,
    M) for an encoder-decoder config (default S // 4, the launcher's)."""
    batch = {"tokens": torch.randint(2, cfg.vocab, (b, s), generator=gen, device=DEV)}
    if cfg.encoder_layers:
        batch["enc_embeds"] = torch.randn((b, frames or max(1, s // 4), cfg.d_model),
                                          generator=gen, device=DEV)
    return batch


def mrope_positions(s: int, grid: int) -> torch.Tensor:
    """(3, 1, S) M-RoPE streams of a `grid` x `grid` patch image followed by
    text: the patches at t = 0 and their row and column, then every stream
    at grid, grid + 1, ... (distinct streams, which a wrong section split
    would read wrongly)."""
    npix = grid * grid
    pos = torch.empty((3, s), dtype=torch.int32, device=DEV)
    idx = torch.arange(npix, dtype=torch.int32, device=DEV)
    pos[0, :npix], pos[1, :npix], pos[2, :npix] = 0, idx // grid, idx % grid
    pos[:, npix:] = grid + torch.arange(s - npix, dtype=torch.int32, device=DEV)
    return pos[:, None]


@torch.no_grad()
def _logits(cfg, params, batch):
    """The last token's logits of one prefill; for a vision config every
    position's, from `train_logits`, which alone splices `pixel_embeds`
    in."""
    if cfg.frontend == "vision":
        return M.train_logits(cfg, params, batch, device=DEV)
    return M.prefill(cfg, params, batch, device=DEV)[0]


def _prefill_pair(cfg, params, batch) -> tuple:
    """Logits (`_logits`) with the kernels and with their plain versions
    (the reference's own `use_kernels=False` configuration), and the kernel
    launches of the first."""
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    before = counters()
    lg_k = _logits(cfg, params, batch)
    used = _since(before)
    lg_p = _logits(plain_cfg, params, batch)
    torch.cuda.synchronize()
    assert _since(before) == used, "use_kernels=False launched a kernel"
    assert bool(torch.isfinite(lg_k).all()) and bool(torch.isfinite(lg_p).all())
    return lg_k, lg_p, used


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _routed_prefill(cfg, params, toks, replay=None) -> tuple:
    """Last-token logits of one prefill and the experts each MoE layer chose
    (`layers.top_k`'s indices, (B,S,k) a layer, in layer order); with
    `replay`, every layer takes those choices in place of its own, gated by
    its own probabilities of them."""
    chosen, own = [], L.top_k

    def top_k(probs, k):
        vals, idx = own(probs, k)
        if replay is not None:
            idx = replay[len(chosen)]
            vals = probs.gather(-1, idx)
        chosen.append(idx)
        return vals, idx

    L.top_k = top_k
    try:
        logits, _ = M.prefill(cfg, params, {"tokens": toks}, device=DEV)
    finally:
        L.top_k = own
    return logits, chosen


def _routing_flips(cfg, params, toks) -> dict:
    """In the serving dtype: how many (token, choice) pairs each MoE layer
    routes differently with the kernels than with their plain versions, the
    first layer that does, and the kernels' logits again with every layer's
    choices taken from the plain run, which must then agree as yi-6b's do
    in bf16 (`E2E_TOLERANCE`), with the same argmax."""
    lg_p, idx_p = _routed_prefill(dataclasses.replace(cfg, use_kernels=False), params, toks)
    lg_k, idx_k = _routed_prefill(cfg, params, toks)
    flips = [int((a != b).sum()) for a, b in zip(idx_k, idx_p)]
    lg_f, _ = _routed_prefill(cfg, params, toks, replay=idx_p)
    torch.cuda.synchronize()
    out = {"routing_pairs_per_layer": idx_p[0].numel(), "routing_flips_by_layer": flips,
           "first_layer_with_a_flip": next((i for i, n in enumerate(flips) if n), None),
           "own_routing_max_rel_to_largest_logit": _rel(lg_k, lg_p),
           "plain_routing_max_rel_to_largest_logit": _rel(lg_f, lg_p),
           "plain_routing_argmax_equal": bool(lg_f.argmax() == lg_p.argmax()),
           "plain_routing_tolerance": E2E_TOLERANCE["yi-6b"][1]}
    assert (out["plain_routing_max_rel_to_largest_logit"] < out["plain_routing_tolerance"]
            and out["plain_routing_argmax_equal"]), out
    return out


def phase_end_to_end(cfg, params, seq: int = 128) -> dict:
    """The same prefill with the CUDA kernels (same tiled quantization, plain
    matmul, attention and chunked scan otherwise) and with their plain
    versions, held to `E2E_TOLERANCE` of the largest logit, with the same
    argmax.  Past the window, the plain versions with the window off must
    fail that tolerance (so the check can see the window).  For an MoE model in the serving dtype, the routing
    choices of both runs (`_routing_flips`)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 2)
    batch = model_inputs(cfg, gen, 1, seq)
    toks = batch["tokens"]
    if cfg.frontend == "vision":
        batch["positions"] = mrope_positions(seq, PATCH_GRID)
        batch["pixel_embeds"] = torch.randn((1, PATCH_GRID ** 2, cfg.d_model), generator=gen,
                                            device=DEV)
    dtype, tol = E2E_TOLERANCE[cfg.name]
    cfg_c = dataclasses.replace(cfg, dtype=dtype)
    lg_k, lg_p, used = _prefill_pair(cfg_c, params, batch)
    rel = _rel(lg_k, lg_p)
    top2 = torch.topk(lg_p[0, -1], 2).values
    what = ("every position's logits (train_logits), "
            f"{PATCH_GRID ** 2} pixel embeddings, distinct M-RoPE streams"
            if cfg.frontend == "vision" else "last-token logits")
    out = {"phase": "end_to_end", "model": cfg.name, "n_layers": cfg.n_layers,
           "what": f"{what}, kernels vs plain versions, B=1 S={seq}, {dtype}"
                   + (f", {batch['enc_embeds'].shape[1]} encoder frames"
                      if cfg.encoder_layers else ""),
           "kernel_launches": used, "max_rel_to_largest_logit": rel, "tolerance": tol,
           "argmax_equal": bool(lg_k[0, -1].argmax() == lg_p[0, -1].argmax()),
           "plain_top2_gap_rel": float((top2[0] - top2[1]) / lg_p.abs().max())}
    if cfg.frontend == "vision":   # the last position's argmax is held, as elsewhere
        out["positions_with_equal_argmax"] = int((lg_k.argmax(-1) == lg_p.argmax(-1)).sum())
    window = layout_window(cfg)
    if window and seq > window:            # the check must see a wrong window
        lg_w, _ = M.prefill(dataclasses.replace(cfg_c, window=0, use_kernels=False), params,
                            batch, device=DEV)
        out["plain_window_off_max_rel_to_largest_logit"] = _rel(lg_w, lg_p)
        assert out["plain_window_off_max_rel_to_largest_logit"] > tol, out
        del lg_w
    del lg_k, lg_p
    if dtype != cfg.dtype:     # the serving dtype too, for the record
        lg_k, lg_p, _ = _prefill_pair(cfg, params, batch)
        out[f"{cfg.dtype}_max_rel_to_largest_logit"] = _rel(lg_k, lg_p)
        out[f"{cfg.dtype}_argmax_equal"] = bool(lg_k[0, -1].argmax() == lg_p[0, -1].argmax())
        if cfg.family == "moe":
            out[f"{cfg.dtype}_routing"] = _routing_flips(cfg, params, toks)
    if cfg.name in E2E_F32_WITNESS:
        lg_k, lg_p, _ = _prefill_pair(dataclasses.replace(cfg, dtype="float32"), params, batch)
        top2 = torch.topk(lg_p[0, -1], 2).values
        out["float32"] = {"max_rel_to_largest_logit": _rel(lg_k, lg_p),
                          "tolerance": E2E_TOLERANCE["mixtral-8x7b"][1],
                          "argmax_equal": bool(lg_k[0, -1].argmax() == lg_p[0, -1].argmax()),
                          "plain_top2_gap_rel": float((top2[0] - top2[1]) / lg_p.abs().max())}
        del lg_k, lg_p
    emit(out)
    assert rel < tol and out["argmax_equal"], out
    if "float32" in out:
        f32 = out["float32"]
        assert f32["max_rel_to_largest_logit"] < f32["tolerance"] and f32["argmax_equal"], out
    return out


def _ranges_on_device(prof, spans=SPANS) -> dict:
    """Device ms of the kernels that start inside each profiler range's span
    on the device timeline (the device side of `record_function`).  Of
    `SPANS`, only `encode` holds other ranges (its blocks' `attention`), so a
    kernel counts in at most one range besides `encode`; of `TRAIN_SPANS`,
    `loss` holds the forward's `attention` ranges, and the backward's
    kernels, launched from autograd's own thread, fall in no range."""
    dev = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    kern = sorted((e for e in dev if e.name not in spans), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in kern]
    out = {}
    for sp in (e for e in dev if e.name in spans):
        lo = bisect.bisect_left(starts, sp.time_range.start)
        hi = bisect.bisect_left(starts, sp.time_range.end)
        out[sp.name] = out.get(sp.name, 0.0) + sum(
            k.time_range.elapsed_us() for k in kern[lo:hi]) / 1e3
    return out


def profile_window(fn, spans=SPANS) -> dict:
    """One warm call of `fn`, then one under `torch.profiler`: wall and
    device-busy ms, the idle share, the ten longest kernels, every kernel of
    the port, and the device ms under each of `spans` (`_ranges_on_device`)."""
    from torch.profiler import ProfilerActivity, profile

    fn()                                           # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()   # not the ranges' own device spans
               if str(e.device_type).endswith("CUDA") and e.key not in spans]

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    ours = [e for e in kernels if any(n in e.key for n in PORT_KERNEL_NAMES)]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:60], "calls": e.count, "ms": dev_us(e) / 1e3}
                            for e in top],
            "port_kernels": [{"name": e.key[:60], "calls": e.count, "ms": dev_us(e) / 1e3}
                             for e in sorted(ours, key=dev_us, reverse=True)],
            "ranges_ms": _ranges_on_device(prof, spans)}


def phase_profile(cfg, params) -> dict:
    """Device time by kernel of one batch-128 decode step, one B=1, S=128
    prefill and one batch-128 prefill (an encoder-decoder config against
    32 frames), from `torch.profiler` (`--profile`): the ten longest
    kernels, every kernel of the port, and the device time of the kernels
    under each of the model's profiler ranges (`SPANS`: attention's product
    and cache, cross-attention's product, the whole encoder, and the MoE
    block's routing, dispatch, experts and combine)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 3)
    batch = model_inputs(cfg, gen, 128, 128)
    one = {k: v[:1] for k, v in batch.items()}
    logits, cache = M.prefill(cfg, params, batch, cache_len=132, device=DEV)
    enc_out = (M.encode(cfg, params, batch["enc_embeds"], device=DEV)
               if cfg.encoder_layers else None)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    # decode first: a profiler session slows the launches after it, and a
    # decode step is bound by the host's launch rate
    out = {"phase": "profile", "model": cfg.name,
           "decode_step_b128": profile_window(
               lambda: M.serve_step(cfg, params, cache, tok, 128, enc_out=enc_out, device=DEV))}
    del logits, cache, enc_out, tok      # the prefills below build a cache of their own
    torch.cuda.empty_cache()
    out["prefill_b1_s128"] = profile_window(lambda: M.prefill(cfg, params, one, device=DEV))
    out["prefill_b128_s128"] = profile_window(lambda: M.prefill(cfg, params, batch, device=DEV))
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the training path: zamba2-1.2b at published width and depth
# ---------------------------------------------------------------------------

TRAIN_CFG_ID, TRAIN_ARCH = "zamba2_1p2b", "zamba2-1.2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 2048, 8, 2
# one schedule for every run of the path (the launcher's default derives it
# from --steps), so that a resumed run steps as the straight run did
TRAIN_OPT = adamw.OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
# kernels on vs off: one f32 step at B=2 x 2048 from one state, the loss
# and the gradient norm held relative to the plain run's.  Only the
# forward's rounding differs (kernel and plain version sum in other
# orders), but at initialisation zamba2 amplifies a change of its forward
# layer by layer (`tools/torch_perturbation_growth.py`), and the backward
# carries the amplified difference into every gradient; so the gradient
# norm is held at 1e-2 and the loss at 1e-4.  `control` (printed) is the
# plain step again with its embeddings scaled by 1 + 2^-22, about two f32
# roundings: the size of change that amplification alone gives.
TRAIN_TOLERANCE = {"batch": 2, "dtype": "float32", "loss": 1e-4, "grad_norm": 1e-2}
TRAIN_CONTROL_EMBED_SCALE = 1 + 2 ** -22
# the profiler ranges of `runtime/trainer.py`, and attention's, inside them
TRAIN_SPANS = ("loss", "backward", "optimizer", "attention")
# where the path's checkpoints go: a memory-backed temporary directory where
# the host has one.  The path writes six checkpoints of 11.6 GB (the
# straight run's four and the resume check's two, 70 GB), more than a disk
# metered by the bytes written may take; the directory is removed when the
# path ends.
TRAIN_CKPT_ROOT = "/dev/shm" if Path("/dev/shm").is_dir() else None


def train_step_launches(cfg, batch: int, seq: int) -> dict:
    """Launches of one train step of a config without an encoder: the
    forward (the stages on batch x seq rows; the head once per CE chunk of
    batch x loss_chunk rows), twice under `cfg.remat`, whose checkpoints
    recompute their forward in the backward; the backward itself is plain."""
    chunk = min(cfg.loss_chunk, seq)
    n = _stage_launches(cfg, M.stages(cfg), batch, seq, 0)
    n["photonic_mac"] += (seq // chunk) * int(ops.uses_tiled_path(batch * chunk, cfg.d_model,
                                                                 cfg.vocab))
    return {k: v * (1 if cfg.remat == "none" else 2) for k, v in n.items()}


def _train(ckpt: str, steps: int, fresh: bool, **fabric_kw):
    """`launch/train.main` on the training path's flags (`fabric_kw`: the
    modelled fabric and its fault, which `main` takes as arguments)."""
    argv = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(steps), "--ckpt", ckpt, "--ckpt-every", str(TRAIN_CKPT_EVERY),
            "--photonic-mac", "--kernels"] + (["--no-resume"] if fresh else [])
    return train.main(argv, opt=TRAIN_OPT, **fabric_kw)


def _train_fabric_check(trainer, res, scen) -> dict:
    """The straight run's modelled fabric against the CPU's plan: 4 bytes a
    master parameter of gradient, the `FABRIC_PRESET` fabric degraded on the
    host; `net_s` healthy before step `FAULT_STEP`, higher from it on."""
    grad_bytes = 4.0 * sum(t.numel() for t in T.leaves(trainer.state.params))
    w = trainer.tcfg.overlap_window_s
    plan = {}
    for key, fb in (("healthy", EC.get_fabric(FABRIC_PRESET)),
                    ("degraded", EC.degrade(FABRIC_PRESET, scen, device="cpu"))):
        ch = EC.plan_collective_channels(grad_bytes, w, fabric=fb, max_channels=64)
        plan[key] = {"channels": ch,
                     "net_s": EC.overlapped_step_s(w, grad_bytes, fb, ch) - w,
                     "cross_pod_gbps": fb.cross_pod_bw_bytes_per_s / 1e9}
    net = [h["net_s"] for h in trainer.history]
    k = FAULT_STEP - 1
    assert res["collective_channels"] == plan["degraded"]["channels"], (res, plan)
    assert net[:k] == [plan["healthy"]["net_s"]] * k, (net, plan)
    assert all(v == res["net_s"] > net[0] for v in net[k:]), (net, res)
    err = _hold(res["net_s"], plan["degraded"]["net_s"], "train/net_s")
    assert res["fabric"] == f"{FABRIC_PRESET}|{scen.name}", res["fabric"]
    return {"fabric": res["fabric"], "fault_step": FAULT_STEP, "grad_bytes": grad_bytes,
            "overlap_window_s": w, "plan_cpu": plan,
            "collective_channels": res["collective_channels"], "net_s": net,
            "max_rel_err_vs_cpu": err}


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _gb(tree) -> float:
    return sum(t.numel() * t.element_size() for t in T.leaves(tree)) / 1e9


def phase_train(ckpt: str) -> dict:
    """The straight run: 8 steps from a fresh state, checkpoints every 2,
    with the `FABRIC_PRESET` fabric modelled and the BASE_MODEL severity-1
    fault injected before step `FAULT_STEP`.  The launches must equal
    `train_step_launches` per step, the loss be finite at every step and
    lower at step 8 than at step 1, and the channel plan and `net_s` equal
    the CPU's (`_train_fabric_check`)."""
    torch.cuda.reset_peak_memory_stats()
    before = counters()
    scen = _fault_scenario()
    trainer, res = _train(ckpt, TRAIN_STEPS, fresh=True, fabric=FABRIC_PRESET,
                          fault_at=FAULT_STEP, fault_scenario=scen)
    torch.cuda.synchronize()
    got = _since(before)
    cfg, hist = trainer.cfg, trainer.history
    published = C.get(TRAIN_CFG_ID)      # full width and depth, bf16, remat
    assert (cfg.remat, cfg.n_layers, cfg.d_model, cfg.dtype) == (
        "full", published.n_layers, published.d_model, "bfloat16"), cfg
    per_step = train_step_launches(cfg, TRAIN_BATCH, TRAIN_SEQ)
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    assert got == want, f"launch counts {got} differ from {want}"
    losses = [h["loss"] for h in hist]
    step_s = [h["step_s"] for h in hist]
    med = sorted(step_s[1:])[(len(step_s) - 1) // 2]
    out = {"phase": "train", "model": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "remat": cfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "opt": dataclasses.asdict(TRAIN_OPT),
           "parameters": sum(t.numel() for t in T.leaves(trainer.state.params)),
           "state_gb": _gb(trainer.state), "losses": losses,
           "ce": [h["ce"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist],
           "step_s": step_s, "median_step_s_after_first": med,
           "train_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
           "ckpt_root": TRAIN_CKPT_ROOT,
           "ckpt_save_s": [h["ckpt_s"] for h in hist if "ckpt_s" in h],
           "wall_s": res["wall_s"], "launches": got, "launches_per_step": per_step,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "card_memory_gb": torch.cuda.get_device_properties(DEV).total_memory / 1e9,
           "fabric": _train_fabric_check(trainer, res, scen)}
    emit(out)
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0], losses
    del trainer
    _free()
    return out


def phase_train_resume(straight: str, ckpt: str) -> dict:
    """A fresh trainer trains 2 steps (checkpoint at step 2), then another
    fresh trainer resumes from that checkpoint and trains to step 4: its
    state (every leaf of params, m and v, and the step) must equal the
    straight run's step-4 checkpoint bit for bit."""
    for step in store.retained_steps(straight):        # only step 4 is read again
        if step != 4:
            shutil.rmtree(Path(straight) / f"step_{step:08d}")
    first, _ = _train(ckpt, 2, fresh=True)
    del first
    _free()
    resumed, _ = _train(ckpt, 4, fresh=False)
    assert resumed.start_step == 2, resumed.start_step
    t0 = time.perf_counter()
    want = store.restore(straight, 4, resumed.state)
    torch.cuda.synchronize()
    restore_4_s = time.perf_counter() - t0
    named = list(T.leaves_with_path(resumed.state))
    differ = [n for (n, a), b in zip(named, T.leaves(want)) if not torch.equal(a, b)]
    out = {"phase": "train_resume", "ckpt_root": TRAIN_CKPT_ROOT, "resumed_from": 2, "to": 4,
           "leaves": len(named),
           "leaves_differing": differ, "restore_s": resumed.restore_s,
           "restore_straight_step4_s": restore_4_s,
           "losses_steps_3_4": [h["loss"] for h in resumed.history]}
    emit(out)
    assert not differ, f"the resumed state differs from the straight run's in {differ}"
    del resumed, want
    _free()
    return out


def _step_metrics(cfg, state, batch) -> tuple:
    before = counters()
    _, m = TR.make_train_step(cfg, TRAIN_OPT, device=DEV)(state, batch)
    m = {k: float(v) for k, v in m.items()}
    return m, _since(before)


def phase_train_kernels_vs_plain() -> dict:
    """One step at B=2 x 2048 from one state, with the kernels and with
    their plain versions: in f32 (held to `TRAIN_TOLERANCE`), and in bf16
    for the record."""
    b = TRAIN_TOLERANCE["batch"]
    out = {"phase": "train_kernels_vs_plain", "batch": b, "seq": TRAIN_SEQ}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(C.get(TRAIN_CFG_ID), dtype=dtype, use_photonic_mac=True,
                                  use_kernels=True)
        state = adamw.init_state(TRAIN_OPT, M.init(cfg, seed=SEED, device=DEV,
                                                   expert_dtype=torch.float32))
        data = SyntheticLM(cfg, DataConfig(global_batch=b, seq_len=TRAIN_SEQ)).batch_at(0)
        batch = {k: torch.as_tensor(v).to(DEV) for k, v in data.items()}
        mk, used = _step_metrics(cfg, state, batch)
        _free()
        plain_cfg = dataclasses.replace(cfg, use_kernels=False)
        mp, plain = _step_metrics(plain_cfg, state, batch)
        want = train_step_launches(cfg, b, TRAIN_SEQ)
        assert used == want, f"{dtype}: launch counts {used} differ from {want}"
        assert not any(plain.values()), f"use_kernels=False launched a kernel: {plain}"
        out[dtype] = {"kernels": mk, "plain": mp, "launches": used,
                      "loss_rel": abs(mk["loss"] - mp["loss"]) / abs(mp["loss"]),
                      "grad_norm_rel": abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]}
        if dtype == "float32":   # the plain step again, its embeddings scaled
            params = dict(state.params, embed=state.params["embed"] * TRAIN_CONTROL_EMBED_SCALE)
            mc, _ = _step_metrics(plain_cfg, state._replace(params=params), batch)
            del params
            out[dtype]["control"] = {
                "embed_scale": TRAIN_CONTROL_EMBED_SCALE, "plain": mc,
                "loss_rel": abs(mc["loss"] - mp["loss"]) / abs(mp["loss"]),
                "grad_norm_rel": abs(mc["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]}
        del state, batch
        _free()
    f32 = out["float32"]
    out["tolerance"] = TRAIN_TOLERANCE
    emit(out)
    assert (f32["loss_rel"] < TRAIN_TOLERANCE["loss"]
            and f32["grad_norm_rel"] < TRAIN_TOLERANCE["grad_norm"]), f32
    return out


# the straight run's steps and schedule, so that each wire step has its
# counterpart; a step's gradient norm must stay within a factor of
# WIRE_GRAD_NORM_FACTOR of the straight run's.  The int8 weights move the
# norm away from the straight run's (0.52x-3.4x over the first 4 steps on an
# H100), as they move the reference's (tests/test_torch_wire.py); a fault in
# the gradient path (a lost pair delta, an unscaled dequantization, a NaN)
# leaves that band.
WIRE_BITS, WIRE_STEPS, WIRE_GRAD_NORM_FACTOR = 8, TRAIN_STEPS, 8.0
# the reference's wire tests (tests/test_kernels.py, tests/test_runtime.py):
# reduced yi-6b at B=2 x 64, and the bars of the wire's master gradients
WIRE_CHECK_ARCH, WIRE_CHECK_BATCH, WIRE_CHECK_SEQ = "yi_6b", 2, 64
WIRE_GRAD_BARS = {16: 0.05, 8: 0.25}


def _wire_payload(params, pw) -> dict:
    """The wire's int8 pairs against the f32 masters they stand for: their
    count, their bytes with the per-layer scales, and the share of the
    master bytes they carry."""
    pairs = [p for n, p in T.leaves_with_path(pw.quantize(params)) if n.endswith("['~q']")]
    int8 = sum(q.numel() for q in pairs)
    scales = 4 * sum(q.shape[0] for q in pairs)
    masters = 4 * sum(t.numel() for t in T.leaves(params))
    return {"pairs": len(pairs), "int8_bytes": int8, "scale_bytes": scales,
            "f32_bytes_they_stand_for": 4 * int8,
            "payload_ratio": (int8 + scales) / (4 * int8),
            "share_of_master_bytes": 4 * int8 / masters}


def _wire_grads_vs_master(device) -> dict:
    """The reference test's bars (`test_wire_grads_close_to_master`) on
    `device`: reduced yi-6b (kernels on), B=2 x 64 from seed 0, the wire's
    master gradients within 0.05 (16 bits) and 0.25 (8 bits) of the f32
    masters' in norm, leaf by leaf; returns the worst leaf of each."""
    cfg = dataclasses.replace(C.get_reduced(WIRE_CHECK_ARCH), use_kernels=True)
    params = M.init(cfg, seed=SEED, device=device)
    gen = np.random.default_rng(SEED)
    batch = {k: torch.as_tensor(gen.integers(0, cfg.vocab, (WIRE_CHECK_BATCH, WIRE_CHECK_SEQ)))
             .to(device) for k in ("tokens", "labels")}

    def grads(tree, leaves):
        return torch.autograd.grad(M.loss_fn(cfg, tree, batch, device=device)[0], leaves)

    p0 = T.map_structure(lambda p: p.detach().requires_grad_(True), params)
    g0 = grads(p0, T.leaves(p0))
    names = [n for n, _ in T.leaves_with_path(params)]
    out = {}
    for bits, bar in WIRE_GRAD_BARS.items():
        pw = W.make_param_wire(dataclasses.replace(cfg, wire_bits=bits))
        v = T.map_structure(lambda p: p.detach().requires_grad_(True), pw.carrier(params))
        g = grads(pw.graft(pw.quantize(params), v), T.leaves(v))
        rel = [float(torch.linalg.norm(a - b) / torch.linalg.norm(a)) for a, b in zip(g0, g)]
        worst = int(np.argmax(rel))
        out[bits] = {"bar": bar, "worst_leaf": names[worst], "worst_rel": rel[worst]}
        assert all(float(torch.linalg.norm(a - b)) <= bar * float(torch.linalg.norm(a)) + 1e-6
                   for a, b in zip(g0, g)), (bits, out[bits])
    return out


def _wire_step_vs_cpu() -> dict:
    """One f32 step of reduced yi-6b (photonic numerics) under the 8-bit
    wire, kernels on, on the card against the port's plain step on the CPU
    from the same state: loss and gradient norm within TRAIN_TOLERANCE."""
    cfg = dataclasses.replace(C.get_reduced(WIRE_CHECK_ARCH), use_photonic_mac=True,
                              use_kernels=True, wire_bits=WIRE_BITS)
    plain = dataclasses.replace(cfg, use_kernels=False)
    data = SyntheticLM(cfg, DataConfig(global_batch=WIRE_CHECK_BATCH,
                                       seq_len=WIRE_CHECK_SEQ)).batch_at(0)
    params = M.init(cfg, seed=SEED, device="cpu")
    res = {}
    for name, c, dev in (("card", cfg, DEV), ("cpu_plain", plain, torch.device("cpu"))):
        state = adamw.init_state(TRAIN_OPT, T.map_structure(lambda t: t.to(dev), params))
        batch = {k: torch.as_tensor(v).to(dev) for k, v in data.items()}
        _, m = TR.make_train_step(c, TRAIN_OPT, param_wire=W.make_param_wire(c),
                                  device=dev)(state, batch)
        res[name] = {k: float(v) for k, v in m.items()}
    card, cpu = res["card"], res["cpu_plain"]
    out = dict(res, loss_rel=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
               grad_norm_rel=abs(card["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"])
    assert (out["loss_rel"] < TRAIN_TOLERANCE["loss"]
            and out["grad_norm_rel"] < TRAIN_TOLERANCE["grad_norm"]), out
    return out


def _wire_launcher_check() -> dict:
    """`launch/train.py --wire-bits 8` (no mesh) for 2 reduced steps on the
    card: losses bit for bit those of the same run without the flag, as
    the reference's launcher trains."""
    losses = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wire_") as tmp:
        for flag in ([], ["--wire-bits", str(WIRE_BITS)]):
            trainer, _ = train.main(["--arch", WIRE_CHECK_ARCH, "--reduced", "--steps", "2",
                                     "--batch", str(WIRE_CHECK_BATCH), "--seq",
                                     str(WIRE_CHECK_SEQ), "--ckpt", f"{tmp}/{len(flag)}",
                                     "--no-resume", "--photonic-mac", "--kernels"] + flag)
            losses["with_flag" if flag else "without"] = [h["loss"] for h in trainer.history]
    assert losses["with_flag"] == losses["without"] and len(losses["without"]) == 2, losses
    return losses


def phase_train_wire(train_out: dict) -> dict:
    """zamba2-1.2b at published width and depth, as `phase_train` builds it
    (bf16 compute, f32 masters, photonic numerics, kernels on, remat
    "full", TRAIN_OPT), trained WIRE_STEPS steps of 8 x 2048 `SyntheticLM`
    tokens through `make_train_step(param_wire=)` under the 8-bit wire:
    the loss finite and falling, each step's gradient norm within a factor
    of WIRE_GRAD_NORM_FACTOR of the straight run's (`train_out`) at that
    step, the launches per step equal to
    `train_step_launches` (the wire launches no kernel), all three kernels
    launched; step seconds, tokens/s and peak memory beside `train`'s, the
    pairs and their payload.  Then, at the reference tests' setting
    (reduced yi-6b, B=2 x 64, seed 0): the master-gradient bars, one f32
    step against the port's plain CPU step, and the launcher's flag."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(C.get(TRAIN_CFG_ID), use_photonic_mac=True, use_kernels=True)
    cfg8 = dataclasses.replace(cfg, wire_bits=WIRE_BITS)
    state = adamw.init_state(TRAIN_OPT, M.init(cfg, seed=SEED, device=DEV,
                                               expert_dtype=torch.float32))
    pw = W.make_param_wire(cfg8)
    payload = _wire_payload(state.params, pw)
    step = TR.make_train_step(cfg8, TRAIN_OPT, param_wire=pw, device=DEV)
    src = SyntheticLM(cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = counters()
    hist = []
    for i in range(WIRE_STEPS):
        batch = {k: torch.as_tensor(v).to(DEV) for k, v in src.batch_at(i).items()}
        t0 = time.perf_counter()
        state, m = step(state, batch)
        row = {k: float(v) for k, v in m.items()}            # the metrics on the host
        row["step_s"] = time.perf_counter() - t0
        hist.append(row)
    got = _since(before)
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = train_step_launches(cfg, TRAIN_BATCH, TRAIN_SEQ)
    want = {k: v * WIRE_STEPS for k, v in per_step.items()}
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    norm_ratio = [a / b for a, b in zip(norms, train_out["grad_norms"])]
    step_s = [h["step_s"] for h in hist]
    med = sorted(step_s[1:])[(len(step_s) - 1) // 2]
    out = {"phase": "train_wire", "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
           "wire_bits": WIRE_BITS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": losses,
           "grad_norms": norms, "grad_norm_vs_train": norm_ratio,
           "grad_norm_factor": WIRE_GRAD_NORM_FACTOR, "step_s": step_s,
           "median_step_s_after_first": med, "train_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
           "train_phase": {"median_step_s_after_first": train_out["median_step_s_after_first"],
                           "train_tokens_per_s": train_out["train_tokens_per_s"],
                           "peak_memory_gb": train_out["peak_memory_gb"],
                           "grad_norms": train_out["grad_norms"]},
           "peak_memory_gb": peak, "launches": got, "launches_per_step": per_step,
           "payload": payload}
    del state, step, batch
    _free()
    out["grads_vs_master"] = _wire_grads_vs_master(DEV)
    out["f32_step_vs_cpu_plain"] = _wire_step_vs_cpu()
    out["launcher_wire_bits"] = _wire_launcher_check()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    assert got == want, f"launch counts {got} differ from {want}"
    assert all(got[name] > 0 for name in KERNELS), got
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0], losses
    assert len(norm_ratio) == WIRE_STEPS and all(
        1 / WIRE_GRAD_NORM_FACTOR <= r <= WIRE_GRAD_NORM_FACTOR for r in norm_ratio), norm_ratio
    _free()
    return out


def phase_train_profile() -> dict:
    """Device time of one train step at the path's size (a fresh state),
    by kernel and by range: the trainer's `loss` and `optimizer`, the
    backward (which holds the recomputed forward) as the rest of the step's
    device time, and the forward's `attention`."""
    cfg = dataclasses.replace(C.get(TRAIN_CFG_ID), use_photonic_mac=True, use_kernels=True)
    state = adamw.init_state(TRAIN_OPT, M.init(cfg, seed=SEED, device=DEV,
                                               expert_dtype=torch.float32))
    data = SyntheticLM(cfg, DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)).batch_at(0)
    batch = {k: torch.as_tensor(v).to(DEV) for k, v in data.items()}
    step = TR.make_train_step(cfg, TRAIN_OPT, device=DEV)
    win = profile_window(lambda: step(state, batch), TRAIN_SPANS)
    # autograd runs the backward on its own thread, whose kernels the
    # `backward` range (opened on this one) does not see: the backward's
    # device time is what the step's leaves to the other two ranges
    r = win["ranges_ms"]
    r["backward_derived"] = win["device_busy_ms"] - r.get("loss", 0.0) - r.get("optimizer", 0.0)
    out = {"phase": "train_profile", "model": cfg.name, "train_step_b8_s2048": win}
    emit(out)
    del state, batch
    _free()
    return out


def run_train_path(profile: bool) -> dict:
    """The training paths, each with the counters at 0 just before it and
    read just after: the straight run (then the resume and kernels-on-vs-off
    checks), the 8-bit wire's run (`train_wire`, then its reduced-size
    checks) and the sharded run over a one-card mesh (`mesh`); then (with
    `profile`) the profiler phase.  Returns each path's launches."""
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_", dir=TRAIN_CKPT_ROOT) as tmp:
        zero_counters()
        straight = phase_train(f"{tmp}/straight")
        launches["zamba2-1.2b train"] = counters()
        phase_train_resume(f"{tmp}/straight", f"{tmp}/resumed")
    phase_train_kernels_vs_plain()
    zero_counters()
    wire = phase_train_wire(straight)
    launches["zamba2-1.2b train_wire"] = wire["launches"]
    mesh = phase_mesh(straight, wire)
    launches["zamba2-1.2b train_mesh"] = mesh["launches"]
    launches["mixtral-8x7b train_mesh"] = mesh["moe"]["launches"]
    launches["zamba2-1.2b train_mesh_wire"] = mesh["wire"]["launches"]
    if profile:
        phase_train_profile()
    return launches


# ---------------------------------------------------------------------------
# the cross-device layer through NCCL, at world size 1
# ---------------------------------------------------------------------------

# the compressed all-reduce's chunk sizes (None: one scale per shard), the
# slice whose int8 levels and scales are held against the CPU's, the
# pipeline's shape (the reference test's stages, zamba2's width), and the
# sharded run's steps (the training path's batch, sequence and schedule)
MESH_CHUNKS = (None, 64)
MESH_QUANT_SLICE = 1 << 24
MESH_PIPE = dict(L=2, D=2048, M=6, MB=8)
MESH_STEPS = 3
MESH_TOLERANCE = {"loss": 1e-5, "grad_norm": 1e-3}     # tests/test_torch_train.py
# mixtral-8x7b trained under the mesh at published width (d_model 4096,
# d_ff 14336, 8 experts, top-2), bf16 compute, f32 masters and experts, cut
# in depth: a layer holds 1.451e9 parameters (its experts 1.409e9), the
# embedding and head 0.262e9.  At world size 1 the sharded step holds 16
# bytes a parameter (parameters, m, v, gradient; the update in place), so
# one layer is 27.4 GB and two 50.6 GB, before the optimizer's per-leaf
# temporaries (a few copies of one layer's 1.88 GB expert stack) and the
# activations.  The one-device step it is held against keeps the old and
# the new state beside the gradient at its update, 28 bytes a parameter:
# 48.0 GB for one layer and 88.5 GB for two, which no 80 GB card holds.
# So one layer; the tokens are mixtral's sequence at `train`'s 8 x 2048
# halved in batch, the experts' f32 rows then about 4.7 GB.
MESH_MOE_ID = "mixtral_8x7b"
MESH_MOE_DEPTH = 1
MESH_MOE_BATCH = (4, 2048)


def _mesh_collectives(mesh) -> dict:
    """The three all-reduces on one f32 vector of zamba2-1.2b's gradient
    length: at world size 1 each must return its input exactly (flat and
    TRINE) or within int8 (compressed: out + new residual equals input +
    incoming residual within f32 rounding, the error within the reference
    test's 8 max|x| / 127), and the int8 levels and scales of a 2^24-element
    slice must equal the CPU's exactly."""
    n = int(C.get(TRAIN_CFG_ID).param_count())
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    x = torch.randn(n, generator=gen, device=DEV)
    res_in = 0.01 * torch.randn(n, generator=gen, device=DEV)
    out = {"elements": n, "bytes": 4 * n}
    flat, trine = CC.flat_all_reduce(x, mesh), CC.trine_all_reduce(x, mesh)
    assert torch.equal(flat, x) and torch.equal(trine, x), "flat/trine differ from the input"
    del flat, trine
    out["flat_ms"] = time_ms(lambda: CC.flat_all_reduce(x, mesh))
    out["trine_ms"] = time_ms(lambda: CC.trine_all_reduce(x, mesh))
    want = x + res_in
    top = float(want.abs().max())
    for chunk in MESH_CHUNKS:
        got, new_res = CC.compressed_all_reduce(x, mesh, residual=res_in, chunk_elems=chunk)
        rounding = float((got + new_res - want).abs().max())
        err = float((got - want).abs().max())
        del got, new_res
        row = {"chunk_elems": chunk, "max_abs_err": err, "bound": 8 * top / 127,
               "out_plus_residual_err": rounding, "rounding_bound": 4 * 2.0 ** -24 * top,
               "ms": time_ms(lambda: CC.compressed_all_reduce(x, mesh, residual=res_in,
                                                              chunk_elems=chunk))}
        part = x[:MESH_QUANT_SLICE]
        q, sc = CC._quantize_int8(part, chunk)
        qc, scc = CC._quantize_int8(part.cpu(), chunk)
        row["slice_levels_equal"] = torch.equal(q.cpu(), qc)
        row["slice_scales_equal"] = torch.equal(sc.cpu(), scc)
        out[f"compressed_chunk_{chunk}"] = row
        assert err <= row["bound"] and rounding <= row["rounding_bound"], row
        assert row["slice_levels_equal"] and row["slice_scales_equal"], row
    del x, res_in, want
    _free()
    return out


def _mesh_pipeline() -> dict:
    """`pipelined_apply` over a one-rank `pipe` mesh (S = 1) against
    `sequential_reference`, forward and gradients, at the reference test's
    tolerances."""
    from torch.distributed.device_mesh import init_device_mesh

    pmesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pipe",))
    p = MESH_PIPE
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    params = {"w": torch.randn((1, p["L"], p["D"], p["D"]), generator=gen, device=DEV)
              * p["D"] ** -0.5,
              "b": 0.01 * torch.randn((1, p["L"], p["D"]), generator=gen, device=DEV)}
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    xs = torch.randn((p["M"], p["MB"], p["D"]), generator=gen, device=DEV)

    def stage_fn(sp, h):
        for i in range(sp["w"].shape[0]):
            h = torch.tanh(h @ sp["w"][i] + sp["b"][i])
        return h

    y = PP.pipelined_apply(stage_fn, params, xs, pmesh)
    g = torch.autograd.grad(torch.sum(y ** 2), [params["w"], params["b"]])
    ys = PP.sequential_reference(stage_fn, params, xs)
    gs = torch.autograd.grad(torch.sum(ys ** 2), [params["w"], params["b"]])
    out = {"shape": p, "forward": compare(y.detach(), ys.detach(), 2e-5, 2e-5, "pipeline forward")}
    for name, a, b in zip(("grad_w", "grad_b"), g, gs):
        out[name] = compare(a, b, 5e-5, 5e-5, f"pipeline {name}")
    return out


def _mesh_moe(mesh) -> dict:
    """mixtral-8x7b at published width, `MESH_MOE_DEPTH` layers, trained
    `MESH_STEPS` steps through `Trainer(mesh=)` (the counters at 0 just
    before and read just after), then the one-device step
    (`make_train_step`, what `Trainer(mesh=None)` runs, without its
    checkpoint) on `M.init`'s state at the same seed and the same batches:
    losses and gradient norms within `MESH_TOLERANCE`, launches equal to
    `train_step_launches` per step on both runs, step seconds and peaks."""
    cfg = dataclasses.replace(C.get(MESH_MOE_ID), n_layers=MESH_MOE_DEPTH,
                              use_photonic_mac=True, use_kernels=True)
    data = DataConfig(global_batch=MESH_MOE_BATCH[0], seq_len=MESH_MOE_BATCH[1])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_moe_", dir=TRAIN_CKPT_ROOT) as tmp:
        tcfg = TR.TrainerConfig(ckpt_dir=tmp, ckpt_every=MESH_STEPS, log_every=10 ** 9,
                                seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        trainer = TR.Trainer(cfg, TRAIN_OPT, data, tcfg, mesh=mesh, resume=False, device=DEV)
        trainer.run(MESH_STEPS, quiet=True)
        torch.cuda.synchronize()
        launches = counters()
        hist = trainer.history
        parameters = sum(t.numel() for t in T.leaves(trainer.state.params))
        del trainer
    _free()
    sharded = {"losses": [h["loss"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist],
               "step_s": [h["step_s"] for h in hist], "ckpt_s": hist[-1]["ckpt_s"],
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}

    torch.cuda.reset_peak_memory_stats()
    before = counters()
    step = TR.make_train_step(cfg, TRAIN_OPT, device=DEV)
    state = adamw.init_state(TRAIN_OPT, M.init(cfg, seed=SEED, device=DEV,
                                               expert_dtype=torch.float32))
    source = SyntheticLM(cfg, data)
    single = {"losses": [], "grad_norms": [], "step_s": []}
    for i in range(MESH_STEPS):
        batch = {k: torch.as_tensor(v).to(DEV) for k, v in source.batch_at(i).items()}
        t0 = time.perf_counter()
        state, m = step(state, batch)
        single["losses"].append(float(m["loss"]))
        single["grad_norms"].append(float(m["grad_norm"]))
        single["step_s"].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    single_launches = _since(before)
    single["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, step
    _free()
    want = {k: v * MESH_STEPS for k, v in
            train_step_launches(cfg, MESH_MOE_BATCH[0], MESH_MOE_BATCH[1]).items()}
    rel = {k: [abs(a - b) / abs(b) for a, b in zip(sharded[k], single[k])]
           for k in ("losses", "grad_norms")}
    out = {"model": cfg.name, "n_layers": cfg.n_layers, "published_n_layers":
           C.get(MESH_MOE_ID).n_layers, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
           "n_experts": cfg.n_experts, "top_k": cfg.top_k, "dtype": cfg.dtype,
           "parameters": parameters, "batch": MESH_MOE_BATCH[0], "seq": MESH_MOE_BATCH[1],
           "steps": MESH_STEPS, "tolerance": MESH_TOLERANCE, "sharded": sharded,
           "single": single, "launches": launches, "single_launches": single_launches,
           "rel_diff": rel, "bitwise": (sharded["losses"] == single["losses"]
                                        and sharded["grad_norms"] == single["grad_norms"])}
    emit({"phase": "mesh_moe", **out})
    assert launches == want and single_launches == want, (launches, single_launches, want)
    assert launches["photonic_mac"] > 0 and launches["flash_attention"] > 0, launches
    assert max(rel["losses"]) < MESH_TOLERANCE["loss"], rel
    assert max(rel["grad_norms"]) < MESH_TOLERANCE["grad_norm"], rel
    assert all(map(math.isfinite, sharded["losses"])), sharded
    return out


def _mesh_wire(mesh, wire: dict) -> dict:
    """zamba2-1.2b at published size under the `WIRE_BITS` parameter wire
    over the mesh (`Trainer(mesh=)` with `cfg.wire_bits`: the gathers move
    int8 levels, dequantized after them), `MESH_STEPS` steps (the counters
    at 0 just before and read just after), against the first `MESH_STEPS`
    steps of `train_wire` (`wire`: the one-device wire on the same flags,
    state and batches): losses and gradient norms within `MESH_TOLERANCE`,
    launches per step equal."""
    cfg = dataclasses.replace(C.get(TRAIN_CFG_ID), use_photonic_mac=True, use_kernels=True,
                              wire_bits=WIRE_BITS)
    data = DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_wire_", dir=TRAIN_CKPT_ROOT) as tmp:
        tcfg = TR.TrainerConfig(ckpt_dir=tmp, ckpt_every=MESH_STEPS, log_every=10 ** 9,
                                seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        trainer = TR.Trainer(cfg, TRAIN_OPT, data, tcfg, mesh=mesh, resume=False, device=DEV)
        trainer.run(MESH_STEPS, quiet=True)
        torch.cuda.synchronize()
        launches = counters()
        hist = trainer.history
        del trainer
    _free()
    sharded = {"losses": [h["loss"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist],
               "step_s": [h["step_s"] for h in hist], "ckpt_s": hist[-1]["ckpt_s"],
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    single = {k: wire[k][:MESH_STEPS] for k in ("losses", "grad_norms", "step_s")}
    single["peak_memory_gb"] = wire["peak_memory_gb"]
    want = {k: v * MESH_STEPS for k, v in wire["launches_per_step"].items()}
    rel = {k: [abs(a - b) / abs(b) for a, b in zip(sharded[k], single[k])]
           for k in ("losses", "grad_norms")}
    out = {"model": cfg.name, "wire_bits": WIRE_BITS, "steps": MESH_STEPS, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "tolerance": MESH_TOLERANCE, "sharded": sharded, "single": single,
           "launches": launches, "rel_diff": rel,
           "bitwise": (sharded["losses"] == single["losses"]
                       and sharded["grad_norms"] == single["grad_norms"])}
    emit({"phase": "mesh_wire", **out})
    assert launches == want, (launches, want)
    assert max(rel["losses"]) < MESH_TOLERANCE["loss"], rel
    assert max(rel["grad_norms"]) < MESH_TOLERANCE["grad_norm"], rel
    assert all(map(math.isfinite, sharded["losses"])), sharded
    return out


def phase_mesh(straight: dict, wire: dict) -> dict:
    """The cross-device layer through NCCL at world size 1: a file-store
    rendezvous, `make_test_mesh(1, 1, 1)` on the card, the three
    all-reduces at zamba2-1.2b's full gradient length, the pipeline at
    S = 1, and zamba2-1.2b trained `MESH_STEPS` steps at full size through
    `Trainer(mesh=)` against the first `MESH_STEPS` steps of `train`'s
    straight run (`straight`, a `Trainer(mesh=None)` on the same flags,
    state and batches): losses and gradient norms within `MESH_TOLERANCE`,
    and its launches per step; then the sharded mixtral run (`_mesh_moe`)
    and zamba2 under the 8-bit wire over the mesh against `train_wire`
    (`wire`, `_mesh_wire`).  The counters are set to 0 just before each
    sharded run and read just after.  NCCL takes no two ranks on one card,
    so nothing here splits work or memory: the `model` axis has size 1,
    where the tensor-parallel split is the identity (ROADMAP.md)."""
    t0 = time.perf_counter()
    out = {"phase": "mesh", "card": card(), "world_size": 1}
    rdv = tempfile.mkdtemp(prefix="chip_smoke_mesh_")      # the store lives as long as the group
    here = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(here)
    dist.init_process_group("nccl", init_method=f"file://{rdv}/rendezvous", rank=0,
                            world_size=1, device_id=here)
    try:
        mesh = make_test_mesh(data=1, model=1, pod=1, device_type="cuda")
        out["backend"] = dist.get_backend()
        out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        out["collectives"] = _mesh_collectives(mesh)
        out["pipeline"] = _mesh_pipeline()

        cfg = dataclasses.replace(C.get(TRAIN_CFG_ID), use_photonic_mac=True, use_kernels=True)
        data = DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_ckpt_",
                                         dir=TRAIN_CKPT_ROOT) as tmp:
            tcfg = TR.TrainerConfig(ckpt_dir=tmp, ckpt_every=MESH_STEPS, log_every=10 ** 9)
            torch.cuda.reset_peak_memory_stats()
            zero_counters()
            trainer = TR.Trainer(cfg, TRAIN_OPT, data, tcfg, mesh=mesh, resume=False,
                                 device=DEV)
            trainer.run(MESH_STEPS, quiet=True)
            torch.cuda.synchronize()
            launches = counters()
            hist = trainer.history
            del trainer
        _free()
        sharded = {"losses": [h["loss"] for h in hist],
                   "grad_norms": [h["grad_norm"] for h in hist],
                   "step_s": [h["step_s"] for h in hist], "ckpt_s": hist[-1]["ckpt_s"],
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        single = {k: straight[k][:MESH_STEPS] for k in ("losses", "grad_norms", "step_s")}
        single["peak_memory_gb"] = straight["peak_memory_gb"]
        want = {k: v * MESH_STEPS for k, v in straight["launches_per_step"].items()}
        rel = {k: [abs(a - b) / abs(b) for a, b in zip(sharded[k], single[k])]
               for k in ("losses", "grad_norms")}
        out.update(sharded=sharded, single=single, launches=launches, steps=MESH_STEPS,
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, tolerance=MESH_TOLERANCE, rel_diff=rel,
                   bitwise=(sharded["losses"] == single["losses"]
                            and sharded["grad_norms"] == single["grad_norms"]))
        emit(out)
        assert launches == want, (launches, want)
        assert all(n > 0 for n in launches.values()), launches
        assert max(rel["losses"]) < MESH_TOLERANCE["loss"], rel
        assert max(rel["grad_norms"]) < MESH_TOLERANCE["grad_norm"], rel
        assert all(map(math.isfinite, sharded["losses"])), sharded
        out["moe"] = _mesh_moe(mesh)
        out["wire"] = _mesh_wire(mesh, wire)
        out["seconds"] = time.perf_counter() - t0
        emit({"phase": "mesh_total", "seconds": out["seconds"]})
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# serving under a mesh through NCCL, at world size 1
# ---------------------------------------------------------------------------

# (config id, layers served): yi-6b at published width cut to 8 of its 32
# layers (its serving path ran all 32 already; 8 keep the phase short),
# zamba2-1.2b as published; each a batch-128 x 128 prefill then
# MESH_SERVE_STEPS decode steps
MESH_SERVE = (("yi_6b", 8), ("zamba2_1p2b", None))
MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_STEPS = 128, 128, 8


def _serve_run(prefill, step, params, batch, steps) -> dict:
    """A prefill and its decode steps, timed each to a synchronize, with
    the counters at 0 just before and read just after, and the peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs = [logits]
    for i, tok in enumerate(steps):
        logits, cache = step(params, cache, tok, MESH_SERVE_PROMPT + i)
        outs.append(logits)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    b = batch["tokens"].shape[0]
    return {"logits": outs, "cache": cache, "launches": counters(),
            "prefill_tokens_per_s": b * MESH_SERVE_PROMPT / (t1 - t0),
            "decode_tokens_per_s": b * len(steps) / (t2 - t1),
            "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def _mesh_serve_model(mesh, cfg_id: str, depth) -> dict:
    """One model's sharded prefill and decode steps (`serve.sharded`) on
    the rank's shards and cache against the one-device `prefill` and
    `serve_step`, bit for bit, kernels on."""
    published = C.get(cfg_id)
    cfg = dataclasses.replace(published, n_layers=depth or published.n_layers,
                              use_photonic_mac=True, use_kernels=True)
    b, s, n = MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_STEPS
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen).to(DEV)}
    steps = [torch.randint(0, cfg.vocab, (b, 1), generator=gen).to(DEV) for _ in range(n)]
    params = M.init(cfg, seed=SEED, device=DEV)
    prefill, psh, _, _ = SV.build_sharded_prefill(cfg, mesh, None, batch, s + n, device=DEV)
    step, *_ = SV.build_sharded_serve_step(cfg, mesh, None,
                                           M.init_cache_abstract(cfg, b, s + n)[0], device=DEV)
    one_prefill = lambda p, bt: M.prefill(cfg, p, bt, s + n, device=DEV)      # noqa: E731
    one_step = lambda p, c, t, pos: M.serve_step(cfg, p, c, t, pos, device=DEV)  # noqa: E731
    _serve_run(one_prefill, one_step, params, batch, steps)     # warm: the first call's costs
    shards = TR.distribute(mesh, params, psh)
    sharded = _serve_run(prefill, step, shards, batch, steps)
    del shards
    _free()
    one = _serve_run(one_prefill, one_step, params, batch, steps)
    bitwise = (all(torch.equal(a, c) for a, c in zip(sharded["logits"], one["logits"]))
               and all(torch.equal(a, c) for a, c in zip(_leaves(sharded["cache"]),
                                                          _leaves(one["cache"]))))
    finite = all(bool(torch.isfinite(t).all()) for t in sharded["logits"])
    out = {"model": cfg.name, "n_layers": cfg.n_layers, "published_n_layers": published.n_layers,
           "batch": b, "prompt": s, "decode_steps": n, "bitwise": bitwise, "finite": finite,
           "logits_shape": list(sharded["logits"][0].shape),
           **{f"{k}_{which}": r[k] for which, r in (("sharded", sharded), ("one_device", one))
              for k in ("prefill_tokens_per_s", "decode_tokens_per_s", "prefill_s",
                        "decode_s", "peak_memory_gb", "launches")}}
    del params, sharded, one
    _free()
    return out


def phase_mesh_serve() -> dict:
    """Serving under a mesh through NCCL at world size 1 (a file-store
    rendezvous, `make_test_mesh(1, 1, 1)` on the card): for each of
    `MESH_SERVE`, `serve.sharded`'s prefill and decode steps on the rank's
    shards (`trainer.distribute`) and cache against the one-device
    `prefill` and `serve_step`, kernels on: logits and cache bit for bit,
    the launches equal, tokens/s and peaks of both (after one untimed
    one-device run, which pays the first call's costs).  The sharded run is
    its own path (`<model> mesh_serve`), its counters at 0 just before it
    and read just after.  At one rank every gather is the shard itself and
    the split and the cache's layout are the identity (ROADMAP.md)."""
    t0 = time.perf_counter()
    rdv = tempfile.mkdtemp(prefix="chip_smoke_mesh_serve_")
    here = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(here)
    dist.init_process_group("nccl", init_method=f"file://{rdv}/rendezvous", rank=0,
                            world_size=1, device_id=here)
    try:
        mesh = make_test_mesh(data=1, model=1, pod=1, device_type="cuda")
        models = [_mesh_serve_model(mesh, cfg_id, depth) for cfg_id, depth in MESH_SERVE]
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    out = {"phase": "mesh_serve", "card": card(), "world_size": 1, "models": models,
           "seconds": time.perf_counter() - t0}
    emit(out)
    for m in models:
        assert m["bitwise"], f"{m['model']}: the sharded serving step differs from one device's"
        assert m["finite"], m["model"]
        assert m["launches_sharded"] == m["launches_one_device"], m
    return {f"{m['model']} mesh_serve": m["launches_sharded"] for m in models}


# ---------------------------------------------------------------------------
# the dry-run on the production meshes
# ---------------------------------------------------------------------------

# (arch, shape, mesh) of the cells the phase runs, each in its own process
DRYRUN_CELLS = (("yi-6b", "train_4k", "single"), ("mixtral-8x7b", "prefill_32k", "multi"),
                ("zamba2-1.2b", "long_500k", "single"))
DRYRUN_TIMEOUT_S = 600


def phase_dryrun() -> dict:
    """`python -m repro_torch.launch.dryrun` on `DRYRUN_CELLS`, the three
    processes at once: one rank of the production mesh over a fake process
    group, on the host (no card, no kernel build).  Prints each cell's
    bottleneck, its three roofline terms and its argument GiB a device:
    host-side counts priced on the modelled TPU-class fabric constants of
    `core/fabric.py`, not times of this card."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                               "--shape", sh, "--mesh", m], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a, sh, m in DRYRUN_CELLS]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=DRYRUN_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    cells = []
    for (a, sh, m), p, log in zip(DRYRUN_CELLS, procs, logs):
        assert p.returncode == 0, f"dry-run {a} {sh} {m} exited {p.returncode}:\n{log[-3000:]}"
        rec = json.loads((ROOT / "benchmarks" / "artifacts" / "torch_dryrun" /
                          f"{C.ALIASES[a]}__{sh}__{m}.json").read_text())
        assert rec["status"] == "ok", rec
        rf = rec["roofline"]
        cells.append({"cell": f"{a} {sh} {m}", "n_devices": rec["n_devices"],
                      "bottleneck": rf["bottleneck"], "compute_s": rf["compute_s"],
                      "memory_s": rf["memory_s"], "collective_s": rf["collective_s"],
                      "args_gib_per_device": rec["memory"]["argument_size_in_bytes"] / 2 ** 30,
                      "temp_gib_per_device": rec["memory"]["temp_size_in_bytes"] / 2 ** 30,
                      "dot_flops": rec["hlo_stats"]["dot_flops"],
                      "collective_bytes": rec["hlo_stats"]["collective_bytes"],
                      "lower_s": rec["lower_s"]})
    out = {"phase": "dryrun", "seconds": time.perf_counter() - t0,
           "priced_on": "the modelled TPU-class fabric of core/fabric.py (metallic_ici); "
                        "host-side counts, not H100 times", "cells": cells}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the model examples and the kernel bench
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parent
# the training example's run: LM_100M, a node failure injected at step 30
E2E_TRAIN_ARGS = ["--full-100m", "--steps", "60", "--fail-at", "30"]


def _script_module(path: str):
    """One of the repo's example or benchmark scripts, loaded from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(Path(path).stem, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(path: str, argv: list) -> tuple:
    """`main(argv)` of a script on the card, its printed lines kept aside:
    (its result, its stdout, seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = _script_module(path).main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    return res, buf.getvalue(), time.perf_counter() - t0


def _falls(losses) -> bool:
    return bool(np.all(np.isfinite(losses))) and losses[-1] < losses[0]


def phase_examples() -> dict:
    """The five model examples and the kernel bench, each `main` on the card
    at its default size (`torch_train_e2e` at `E2E_TRAIN_ARGS`), held to
    checks like the reference's smoke tests': the paper's claims True and a
    falling loss (quickstart), every request finished (continuous
    batching), the launcher's report (serve batched), errors that grow as
    the banks narrow and finite losses (ablation), a resume after the
    injected failure and a lower loss at the end than at the start
    (training), and the bench's distortion rows and times."""
    out, t_all = {"phase": "examples"}, time.perf_counter()

    res, text, sec = _run_main("examples/torch_quickstart.py", [])
    assert all(res["checks"].values()) and _falls(res["losses"]), res
    out["quickstart"] = {"seconds": sec, "checks": res["checks"], "losses": res["losses"]}

    res, text, sec = _run_main("examples/torch_continuous_batching.py", [])
    assert len(res["finished"]) == len(res["requests"]), "requests left unfinished"
    assert all(r.done and len(r.out) == r.max_new for r in res["requests"])
    out["continuous_batching"] = {"seconds": sec, "requests": len(res["requests"]),
                                  "new_tokens": res["new_tokens"], "run_s": res["seconds"]}

    res, text, sec = _run_main("examples/torch_serve_batched.py", [])
    assert "prefill:" in text and "decode" in text and "generated shape: (4, 16)" in text, text
    out["serve_batched"] = {"seconds": sec, "report": [ln for ln in text.splitlines()
                                                       if ln.startswith(("prefill", "decode"))]}

    res, text, sec = _run_main("examples/torch_photonic_mac_ablation.py", [])
    errs = [res["quant_rel_error"][b] for b in sorted(res["quant_rel_error"], reverse=True)]
    losses = [res["f32_loss"], *res["photonic_loss"].values()]
    assert errs == sorted(errs) and bool(np.all(np.isfinite(losses))), res
    out["photonic_mac_ablation"] = {"seconds": sec, **res}

    res, text, sec = _run_main("examples/torch_train_e2e.py", E2E_TRAIN_ARGS)
    losses = [h["loss"] for h in res["history"]]
    assert res["restarts"] == 1 and res["resumed_from"] == [20], res["resumed_from"]
    assert [h["step"] for h in res["history"]] == list(range(1, 61)) and _falls(losses), losses
    out["train_e2e"] = {"seconds": sec, "args": E2E_TRAIN_ARGS, "resumed_from": res["resumed_from"],
                        "first_loss": losses[0], "last_loss": losses[-1],
                        "median_step_s": float(np.median([h["step_s"] for h in res["history"]]))}

    res, text, sec = _run_main("benchmarks/torch_kernels_bench.py", [])
    errs = [r["rel_err"] for r in res["rows"]]
    assert errs == sorted(errs) and all(0 < e < 1 for e in errs), res["rows"]
    assert all(r["ms"] > 0 for r in res["timed"]), res["timed"]
    out["kernels_bench"] = {"seconds": sec, **res}
    out["seconds"] = time.perf_counter() - t_all
    emit(out)
    return out


# ---------------------------------------------------------------------------


def kernel_summary(kern: dict, launches: dict, by_path: dict) -> dict:
    def pick(rows, match):
        return next(r for r in rows if match(r))
    mac = pick(kern["photonic_mac"]["timed"], lambda r: tuple(r["shape"]) == MAC_HEADLINE)
    att = pick(kern["flash_attention"]["timed"],
               lambda r: r["model"] == "yi-6b" and (r["shape"]["b"], r["shape"]["sq"]) == ATTN_HEADLINE)
    ssm = pick(kern["ssm_scan"]["timed"], lambda r: r["shape"]["name"] == SSM_HEADLINE)
    paths = {name: {model: n[name] for model, n in by_path.items()} for name in KERNELS}
    return {"kernels": [
        {"name": "photonic_mac", "route": "cuda",
         "source": "src/repro_torch/csrc/photonic_mac.cu",
         "replaces": "src/repro/kernels/photonic_mac.py:60",
         "launches": launches["photonic_mac"], "launches_by_path": paths["photonic_mac"],
         "max_abs_err": kern["photonic_mac"]["max_abs_err"],
         "ms": mac["ms"], "plain_ms": mac["plain_ms"], "bound_ms": mac["bound_ms"],
         "bound_by": mac["bound_by"], "library_ms": mac["library_ms"],
         "shape": {"m": MAC_HEADLINE[0], "k": MAC_HEADLINE[1], "n": MAC_HEADLINE[2],
                   "x": "bfloat16"}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:81",
         "launches": launches["flash_attention"], "launches_by_path": paths["flash_attention"],
         "max_abs_err": kern["flash_attention"]["max_abs_err"],
         "ms": att["ms"], "plain_ms": att["plain_ms"], "bound_ms": att["bound_ms"],
         "bound_by": att["bound_by"], "library_ms": att["library_ms"],
         "shape": {**att["shape"], "qkv": "bfloat16", "causal": True}},
        {"name": "ssm_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan.py:77",
         "launches": launches["ssm_scan"], "launches_by_path": paths["ssm_scan"],
         "max_abs_err": kern["ssm_scan"]["max_abs_err"],
         "ms": ssm["ms"], "plain_ms": ssm["plain_ms"], "bound_ms": ssm["bound_ms"],
         "bound_by": ssm["bound_by"], "library_ms": None,
         "shape": {**ssm["shape"], **ssm["dtypes"]}},
    ]}


# each serving path: (config id, `launch/serve.py` arch, kernels it must launch)
PATHS = [
    ("yi_6b", "yi-6b", ("photonic_mac", "flash_attention")),
    ("zamba2_1p2b", "zamba2-1.2b", ("photonic_mac", "flash_attention", "ssm_scan")),
    ("xlstm_350m", "xlstm-350m", ("photonic_mac", "ssm_scan")),
    ("mixtral_8x7b", "mixtral-8x7b", ("photonic_mac", "flash_attention")),
    ("seamless_m4t_medium", "seamless-m4t-medium", ("photonic_mac", "flash_attention")),
    ("qwen2_vl_72b", "qwen2-vl-72b", ("photonic_mac", "flash_attention")),
    ("yi_34b", "yi-34b", ("photonic_mac", "flash_attention")),
    ("deepseek_67b", "deepseek-67b", ("photonic_mac", "flash_attention")),
    ("gemma3_27b", "gemma3-27b", ("photonic_mac", "flash_attention")),
    ("grok1_314b", "grok-1-314b", ("photonic_mac", "flash_attention")),
]
# the training paths that run fewer than all three kernels (the others run all)
TRAIN_PATH_NEEDS = {"mixtral-8x7b train_mesh": ("photonic_mac", "flash_attention")}
# the kernels each sharded serving path must launch
MESH_SERVE_NEEDS = {"yi-6b mesh_serve": ("photonic_mac", "flash_attention"),
                    "zamba2-1.2b mesh_serve": ("photonic_mac", "flash_attention", "ssm_scan")}
# the paths that take yi-6b's phases: the batcher's 8 ragged requests, then
# batch 128
BATCHER_ARCHS = ("yi-6b", "mixtral-8x7b", "qwen2-vl-72b", "yi-34b", "deepseek-67b",
                 "gemma3-27b", "grok-1-314b")
# depth cuts (config id -> layers served): mixtral's bf16 experts are 2.82 GB
# a layer, so 24 layers (72.7 GB of weights with the f32 attention, embedding
# and head) leave room for batch-128 transients on an 80 GB card; a
# qwen2-vl layer is 3.51 GB in f32 and its embedding and head 9.97 GB, so
# 18 layers (73.2 GB) are the deepest stack that leaves 4 GB free at the
# batch-128 prefill's peak (PERF.md, section 4).  The same rule for the
# other four, from one measured peak each (card 85.02 GB, so the peak may
# reach 81.02; a layer costs its f32 weights plus its share of the
# batch-128 x 132 K/V cache, the rest of the peak is depth-independent):
#   yi-34b      2.231 GB a layer + 0.069 cache, embedding and head 3.67;
#               31 layers peaked at 78.65, so 32 reach about 80.95
#   deepseek-67b  2.768 + 0.069, 6.71; 23 peaked at 75.97, so 24 reach
#               about 78.80 and 25 about 81.64
#   gemma3-27b  1.652 + 0.138 (16 K/V heads), tied 5.64; 38 peaked at
#               77.21, so 40 reach about 80.79 and 41 about 82.58
#   grok-1      10.016 (bf16 experts, 9.66 of it) + 0.069, 6.44; 5 peaked
#               at 66.36 (the experts' f32 silu rows at d_ff 32768), so 6
#               reach about 76.45 and 7 do not fit
DEPTH = {"mixtral_8x7b": 24, "qwen2_vl_72b": 18, "yi_34b": 32, "deepseek_67b": 24,
         "gemma3_27b": 40, "grok1_314b": 6}
# the end-to-end check past the window (config id -> (tokens, layers, config
# changes)), on a model built again: mixtral in f32 at 4224 tokens, whose
# plain attention's f32 scores take about 9 GB, which 24 layers of weights
# do not leave, so at 16 layers; gemma3-27b as published, 5:1 local:global
# (the reference reaches those kinds only through family "interleaved"),
# two groups of 5 local (window 1024) + 1 global layers at 2048 tokens, in
# bf16
E2E_LONG = {"mixtral_8x7b": (4224, 16, {}),
            "gemma3_27b": (2048, 12, {"family": "interleaved"})}


def run_path(cfg_id: str, arch: str, profile: bool) -> dict:
    """Initialise one model, drive its serving path with the counters at 0
    just before and read just after, then the end-to-end check.  Returns the
    path's launches; its weights are freed on return."""
    published = C.get(cfg_id)
    cfg = dataclasses.replace(published, n_layers=DEPTH.get(cfg_id, published.n_layers),
                              use_photonic_mac=True, use_kernels=True)
    t0 = time.perf_counter()
    params = M.init(cfg, seed=SEED, device=DEV)
    torch.cuda.synchronize()
    emit({"phase": "init", "model": cfg.name, "n_layers": cfg.n_layers,
          "published_n_layers": published.n_layers, "d_model": cfg.d_model,
          "encoder_layers": cfg.encoder_layers,
          "parameters": sum(t.numel() for t in _leaves(params)),
          "master_dtype": "float32",
          "expert_dtype": str(params["stages"][0]["moe_0"]["moe"]["wi"].dtype).removeprefix(
              "torch.") if cfg.family == "moe" else None,
          "weights_gb": sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9,
          "seconds": time.perf_counter() - t0})

    zero_counters()
    if arch in BATCHER_ARCHS:
        lengths, max_news = [60, 250, 131, 97, 200, 129, 77, 180], [4, 8, 6, 5, 7, 4, 8, 6]
        cont = phase_serve_continuous(cfg, params, lengths, max_news, max_len=512, bucket=128)
        if arch == "yi-6b":
            phase_serve_fabric(cfg, params, lengths, max_news, 512, cont)
        phase_serve_batch128(cfg, params, arch)
        if arch == "mixtral-8x7b":   # 33 x 128 tokens, past the 4096 window
            phase_long_prefill(cfg, params, 4224)
    elif arch == "zamba2-1.2b":
        # exact-length prefills of 97 and 24 (<= 128, no power of two), 128,
        # 256, 384, 512, 1024 (multiples of 128) and 200 (neither: the
        # reference runs its sequential oracle there, the kernel's function)
        lengths = [n + 1 for n in (97, 128, 256, 200, 512, 24, 1024, 384)]
        phase_serve_continuous(cfg, params, lengths, [4, 8, 6, 5, 7, 4, 8, 6], max_len=1056)
        phase_serve_batch128(cfg, params, arch)
        phase_long_prefill(cfg, params, 4096)
    elif arch == "seamless-m4t-medium":   # the batcher serves no encoder (Queue 3)
        phase_serve_batch128(cfg, params, arch)
        phase_long_encoder(cfg, params)
    else:
        phase_serve_batch128(cfg, params, arch)
    launches = counters()

    phase_end_to_end(cfg, params, 512 if arch == "zamba2-1.2b" else 128)
    if profile:
        phase_profile(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if cfg_id in E2E_LONG:
        seq, depth, changes = E2E_LONG[cfg_id]
        cut = dataclasses.replace(cfg, n_layers=depth, **changes)
        params = M.init(cut, seed=SEED, device=DEV)
        phase_end_to_end(cut, params, seq)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["kernels", "photonic_mac", "flash_attention", "ssm_scan",
                                       "engine", "mesh_serve", "dryrun"],
                    default=None,
                    help="stop after this phase: a kernel's comparisons (for work on that "
                         "kernel), 'engine' for the engine phases alone (no kernel build), "
                         "'mesh_serve' for serving under a mesh alone, 'dryrun' for the "
                         "dry-run cells alone (no kernel build); prints no ok line")
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel for decode and prefill, per model")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of the engine phases' sampled rows, window and fault scenarios")
    args = ap.parse_args()
    t_start = time.perf_counter()
    dev = phase_device(build=args.only not in ("engine", "dryrun"))
    if args.only in ("engine", "mesh_serve", "dryrun"):
        {"engine": lambda: run_engine(args.seed), "mesh_serve": phase_mesh_serve,
         "dryrun": phase_dryrun}[args.only]()
        print(dev["nvidia_smi"], flush=True)
        return
    kern = phase_kernels(only=None if args.only == "kernels" else args.only)
    if args.only is not None:
        for c in kern["checks"]:
            emit(c)
        print(dev["nvidia_smi"], flush=True)
        return
    run_engine(args.seed)

    by_path = {}
    for cfg_id, arch, needs in PATHS:
        by_path[arch] = run_path(cfg_id, arch, args.profile)
        for name in needs:
            assert by_path[arch][name] > 0, f"the {arch} path never launched {name}"
    for path, n in run_train_path(args.profile).items():
        by_path[path] = n
        for name in TRAIN_PATH_NEEDS.get(path, KERNELS):
            assert n[name] > 0, f"the {path} path never launched {name}"
    for path, n in phase_mesh_serve().items():
        by_path[path] = n
        for name in MESH_SERVE_NEEDS[path]:
            assert n[name] > 0, f"the {path} path never launched {name}"
    phase_dryrun()
    launches = {name: sum(n[name] for n in by_path.values()) for name in KERNELS}
    phase_examples()

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit(kernel_summary(kern, launches, by_path))
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
