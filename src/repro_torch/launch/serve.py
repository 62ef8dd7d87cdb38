"""Batched serving from the command line: batched prefill + greedy decode loop.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
      --batch 128 --prompt-len 128 --max-new 4 --photonic --kernels

Serving loop: batch B prompts -> prefill -> greedy decode with a static-shape
KV cache; reports per-phase latency and tokens/s, timed with
`torch.cuda.synchronize()` around each phase.  Runs on the card unless
`--device cpu` is given (`--reduced` makes that practical).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch

from repro_torch import configs as C
from repro_torch import require_device
from repro_torch.models import model as M


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg, params, prompts: torch.Tensor, max_new: int, device,
                enc_embeds: Optional[torch.Tensor] = None) -> dict:
    """Prefill `prompts` (B,S) and decode `max_new` tokens greedily.  Returns
    the generated ids (B,max_new), the last logits and the phase times.

    An encoder-decoder config takes `enc_embeds` (B,Se,M): as in the
    reference, the encoder runs once before the timed prefill for the
    decode steps' `enc_out`, and once more inside the prefill.  An M-RoPE
    config prefills with equal (3,B,S) position streams."""
    device = torch.device(device)
    b, s = prompts.shape
    cache_len = s + max_new
    batch = {"tokens": prompts}
    if cfg.mrope:
        pos = torch.arange(s, dtype=torch.int32, device=device)
        batch["positions"] = pos[None, None].expand(3, b, s)
    enc_out = None
    if enc_embeds is not None:
        batch["enc_embeds"] = enc_embeds
        enc_out = M.encode(cfg, params, enc_embeds, device=device)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, batch, cache_len=cache_len, device=device)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(max_new - 1):
        logits, cache = M.serve_step(cfg, params, cache, tok, s + i, enc_out=enc_out,
                                     device=device)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out_tokens.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out_tokens, dim=1), "logits": logits,
            "prefill_s": t_prefill, "decode_s": t_decode,
            "prefill_tokens": b * s, "decode_tokens": b * (max_new - 1)}


def main(argv: Optional[Sequence[str]] = None, params=None, cfg=None) -> dict:
    """Parse the flags, build the model, serve one batch and report.

    `params` may be weights already built on the device; `cfg` is then their
    config (default: the `--arch` config).  A config whose stage layout
    differs from the weights' (a depth-cut model handed over with the
    published config) raises `ValueError` (`model.check_params_layout`).  `--photonic` and `--kernels`
    set the numerics of either config."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--photonic", action="store_true",
                    help="route every linear through the photonic-MAC numerics")
    ap.add_argument("--kernels", action="store_true",
                    help="use the hand-written CUDA kernels (needs --device cuda)")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    if cfg is None:
        cfg = C.get_reduced(args.arch) if args.reduced else C.get(args.arch)
    cfg = dataclasses.replace(cfg, use_photonic_mac=args.photonic, use_kernels=args.kernels)
    if params is None:
        params = M.init(cfg, seed=args.seed, device=device)
    else:
        M.check_params_layout(cfg, params)

    b, s = args.batch, args.prompt_len
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 1)
    prompts = torch.randint(2, cfg.vocab, (b, s), generator=gen, device=device)
    enc_embeds = None
    if cfg.encoder_layers:   # the audio frontend's frames: S // 4 of them
        enc_embeds = torch.randn((b, max(1, s // 4), cfg.d_model), generator=gen,
                                 device=device)

    res = serve_batch(cfg, params, prompts, args.max_new, device, enc_embeds=enc_embeds)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device : {where}")
    print(f"prefill: {res['prefill_s']*1e3:.1f} ms for {b}x{s} tokens "
          f"({res['prefill_tokens']/res['prefill_s']:.0f} tok/s)")
    print(f"decode : {res['decode_s']*1e3:.1f} ms for {res['decode_tokens']} tokens "
          f"({res['decode_tokens']/max(res['decode_s'], 1e-9):.0f} tok/s)")
    gen_ids = res["tokens"]
    print(f"generated shape: {tuple(gen_ids.shape)}; sample: {gen_ids[0, :16].tolist()}")
    return res


if __name__ == "__main__":
    main()
