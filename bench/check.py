"""What decides `correct`: the window's own output held to the plain
reference (`reference/<module>.py`), after the window has closed.

The numbers, each compared where `limits/<cell>.json` gives it a limit:

  gap       the widest gap, in logits, by which a served token's logit
            lies below the reference's best at its position, over every
            token served to a sample of the requests: the requests the
            window finished, drawn from the seed with the longest among
            them, until they hold `SERVED` tokens, and `SLOTS` requests
            still in their slots, drawn from the seed.
  step_err  the widest relative gap, max |port - reference| over the
            reference's max |logit|, of the logits of one further decode
            step on the batcher's own cache (the call the batcher makes,
            at its slots and positions), over the sampled slots.
  gap_mean, step_err_med   the mean gap over those tokens and the median
            relative gap over those slots: steadier than the widest,
            where a rare near-tie (a router's top-k) flips on rounding.

Where the model routes, the further step's routing is read as the program
made it (its `top_k`, recorded in that call alone), and the reference
follows it in a shadow of the step's row (`reference.Seq.force`):

  step_err_routed, step_err_routed_med   step_err and step_err_med of the
            logits against the shadow row's: what the step computes given
            its experts, apart from which experts it chose.
  flips     the sampled slots' choices, over the layers, that differ from
            the reference's own top-k at the step's row.
  flip_margin   the widest, over the slots, of the reference's probability
            of its own choices less that of the program's at the slot's
            first flipped layer (0 with no flip): below it the two routed
            alike, so a sound program flips there only on a near-tie, and
            the flips above it follow from the first.  It checks the
            routing that step_err_routed takes from the program.

The reference runs each sampled request as the batcher served it (its
padded prefill call, then one decode call per token: `reference.Seq`),
from the same weights and tokens, with the photonic quantisation worked
out again.  The control (`control=True`, never in the benchmark's own
runs) is the reference with every product's inputs rounded to float8
e4m3: its readings are the same two numbers for the token it puts first
and for its logits.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from bench.generator import SAMPLE, rng

SERVED = 192     # served tokens of finished requests in the sample, at least
SLOTS = 8        # requests in their slots whose next step is compared


def reference(name: str):
    """The reference module `name` of this checkout."""
    return importlib.import_module(f"bench.reference.{name}")


def draw_sample(loop, seed: int):
    """(finished requests, (slot, request) pairs in flight), from the seed."""
    g = rng(seed, SAMPLE)
    done = [s for s in loop.served if s.finished]
    picked: List = []
    if done:
        longest = max(range(len(done)), key=lambda i: (done[i].max_new, -i))
        order = [longest] + [i for i in g.permutation(len(done)).tolist() if i != longest]
        n = 0
        for i in order:
            if n >= SERVED:
                break
            picked.append(done[i])
            n += done[i].max_new
    flying = [(slot, r.out.served) for slot, r in enumerate(loop.batcher.slot_req)
              if r is not None]
    take = g.permutation(len(flying))[:SLOTS].tolist()
    return picked, [flying[i] for i in sorted(take)]


def port_step(loop, slots: List[int]):
    """One further decode step on the batcher's cache, as the batcher calls
    it: the logits of `slots` (f32, on the host), and where the model
    routes, its experts for them, (slots, layers, top_k)."""
    from repro_torch.models import layers, model as M

    b = loop.batcher
    routes = []
    top_k = layers.top_k

    def recorded(probs, k):
        vals, idx = top_k(probs, k)
        routes.append(idx[slots, -1].cpu())
        return vals, idx
    layers.top_k = recorded
    try:
        logits, b.cache = M.serve_step(b.cfg, b.params, b.cache, b.last_tok[:, None], b.pos,
                                       device=b.device)
    finally:
        layers.top_k = top_k
    return logits[slots, -1].float().cpu(), (torch.stack(routes, 1) if routes else None)


def _seq(ref, mix, served, in_flight: bool, force=None):
    p, out = served.prompt, served.tokens
    core = p[:-1]
    plen = mix.bucket_of(len(p))
    dec = [p[-1]] + (out if in_flight else out[:-1])
    return ref.Seq(prefill=core + [0] * (plen - len(core)), n_real=len(core), decode=dec,
                   m_prefill=plen, m_decode=mix.n_slots, force=force)


def consistent(loop, flying) -> List[str]:
    """Faults in the slots' state that the loop's records contradict."""
    b, bad = loop.batcher, []
    for slot, s in flying:
        want_pos = len(s.prompt) - 1 + len(s.tokens)
        want_tok = s.tokens[-1] if s.tokens else s.prompt[-1]
        if int(b.pos[slot]) != want_pos or int(b.last_tok[slot]) != want_tok:
            bad.append(f"slot {slot}: pos {int(b.pos[slot])} / token {int(b.last_tok[slot])}, "
                       f"records {want_pos} / {want_tok}")
    return bad


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.cpu(), ref.cpu()
    return float((a - ref).abs().max() / ref.abs().max())


def _summary(gaps: List[torch.Tensor], errs: List[float], routed: List[float]) -> Dict[str, float]:
    g = torch.cat(gaps) if gaps else torch.zeros(1)
    out = {"gap": float(g.max()), "gap_mean": float(g.mean()),
           "step_err": max(errs, default=0.0),
           "step_err_med": float(np.median(errs)) if errs else 0.0}
    if routed:
        out.update(step_err_routed=max(routed), step_err_routed_med=float(np.median(routed)))
    return out


def _gaps(lg: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """The reference's best logit less its logit of each token, by row."""
    return (lg.max(-1).values - lg.gather(1, toks[:, None])[:, 0]).cpu()


def readings(ref_logits, served, port_last) -> Dict[str, float]:
    """gap (widest) and gap_mean over the served tokens; step_err (widest)
    and step_err_med (median) over the in-flight rows' next step
    (`port_last[i]` for in-flight request i, else None), and against a
    shadow row where the reference followed the program's routing."""
    gaps, errs, routed = [], [], []
    for lg, s, last in zip(ref_logits, served, port_last):
        n = len(s.tokens)
        if n:
            gaps.append(_gaps(lg[:n], torch.tensor(s.tokens, device=lg.device)))
        if last is not None:
            errs.append(_rel(last, lg[n]))
            if len(lg) > n + 1:
                routed.append(_rel(last, lg[n + 1]))
    return _summary(gaps, errs, routed)


def control_readings(ref_logits, ctl_logits, served, in_flight, forced=None) -> Dict[str, float]:
    """The same numbers for the control: the reference's gap of the token
    the control puts first, at every position the sample was served at,
    and the control's logits of the in-flight rows' next step, against the
    reference's own and, with `forced`, against the reference that
    followed the control's routing at that step."""
    gaps, errs, routed = [], [], []
    for i, (lg, cl, s, fl) in enumerate(zip(ref_logits, ctl_logits, served, in_flight)):
        n = len(s.tokens)
        if n:
            gaps.append(_gaps(lg[:n], cl[:n].argmax(-1)))
        if fl:
            errs.append(_rel(cl[n], lg[n]))
            if forced is not None:
                routed.append(_rel(cl[n], forced[i][n + 1]))
    return _summary(gaps, errs, routed)


def route_readings(probs, chosen, k: int) -> Dict[str, float]:
    """flips and flip_margin of the choices `chosen[i]` (layers, k) against
    the reference's probabilities `probs[i]` (layers, experts) at the same
    rows (one request's step row each)."""
    flips, margin = 0, 0.0
    for p, c in zip(probs, chosen):
        p, c = p.cpu(), c.cpu()
        top = torch.sort(p, dim=-1, descending=True, stable=True)
        own = top.indices[:, :k].sort(-1).values
        differ = [layer for layer in range(len(p))
                  if not torch.equal(own[layer], c[layer].sort().values)]
        flips += len(differ)
        if differ:
            first = differ[0]
            margin = max(margin, float(top.values[first, :k].sum() - p[first, c[first]].sum()))
    return {"flips": float(flips), "flip_margin": margin}


def load_limits(root: Path, cell: str) -> Dict[str, dict]:
    return json.loads((root / "bench" / "limits" / f"{cell}.json").read_text())["limits"]


def judge(values: Dict[str, float], limits: Dict[str, dict]) -> Dict[str, dict]:
    return {k: {"value": values[k], "limit": limits[k]["limit"]} for k in limits}


def run(loop, mix, conf: dict, params, seed: int, ref, control: bool = False) -> dict:
    """Compare the window's output with the reference (the module `ref`).
    Frees the batcher's cache first: the reference runs in the memory it
    held."""
    finished, flying = draw_sample(loop, seed)
    faults = consistent(loop, flying)
    port, routes = port_step(loop, [slot for slot, _ in flying]) if flying else (None, None)
    loop.batcher.cache = None
    if params["embed"].is_cuda:
        torch.cuda.empty_cache()
    served = finished + [s for _, s in flying]
    in_flight = [False] * len(finished) + [True] * len(flying)

    def seqs(force=None):
        return ([_seq(ref, mix, s, False) for s in finished]
                + [_seq(ref, mix, s, True, None if force is None else force[i])
                   for i, (_, s) in enumerate(flying)])
    last = [None] * len(finished) + [port[i] for i in range(len(flying))]
    probs: list = []
    ref_logits = ref.forward(conf, params, seqs(routes), routes=probs)
    rd = readings(ref_logits, served, last)
    if routes is not None:
        rd.update(route_readings(probs[len(finished):], routes, conf["top_k"]))
    out = {"readings": rd, "faults": faults,
           "sample": {"finished": len(finished), "in_flight": len(flying),
                      "served_tokens": int(sum(len(s.tokens) for s in served)),
                      "reference_rows": int(sum(len(q.prefill) + len(q.decode)
                                                for q in seqs()))}}
    if control:
        ctl_probs: list = []
        ctl = ref.forward(conf, params, seqs(), act=ref.fp8, routes=ctl_probs)
        chosen = None
        if routes is not None:
            k = conf["top_k"]
            chosen = [ref.top_k(p, k)[1] for p in ctl_probs[len(finished):]]
            forced = [None] * len(finished) + ref.forward(conf, params, seqs(chosen))[len(finished):]
        out["control"] = control_readings(ref_logits, ctl, served, in_flight,
                                          forced if routes is not None else None)
        if routes is not None:
            out["control"].update(route_readings(probs[len(finished):], chosen, k))
    return out
