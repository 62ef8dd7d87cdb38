"""Reference of a decoder-only transformer served by a continuous batcher:
dense SwiGLU blocks (yi-6b) or top-k routed SwiGLU experts (mixtral),
GQA attention with RoPE and an optional sliding window, RMSNorm, and the
photonic-MAC numerics on every linear.  Plain PyTorch, f32, TF32 off.

The equations (the configuration file's keys in brackets):
  h        = embed[token]
  block    : h += Attn(RMSNorm(h)); h += MLP(RMSNorm(h)) or MoE(RMSNorm(h))
  RMSNorm  = x / sqrt(mean(x^2) + [norm_eps]) * (1 + scale)
  Attn     : q, k, v = x Wq, x Wk, x Wv; RoPE ([rope_theta], the two halves
             of each head rotated); softmax(q k^T / sqrt(head_dim)) v over
             the keys at or before the query (and within [window] of it
             where [attn_pattern] is "sliding"); query head i reads KV head
             i // (n_heads / n_kv_heads); output through Wo
  MLP      = (silu(x Wg) * (x Wi)) Wo
  MoE      : router logits x Wr, softmax, the [top_k] largest (the lower
             expert first among equal ones), the gates renormalised over
             them; each (token, choice) in choices-major order takes the
             next of its expert's max(1, int([capacity_factor] S k / E))
             places for a call of S tokens, and past them is dropped; y =
             sum of gate * MLP_expert(x) over the kept choices
  logits   = RMSNorm(h) W_head
  linear   : with [use_photonic_mac], x (w_q * scale), w_q the
             [photonic_bits]-bit levels round(w / scale) and scale
             max|w| / (2^(bits-1) - 1): one scale per 128 x 128 bank
             when the call's rows M and the weight's K and N are all
             multiples of 128, else one per column.  The routed experts'
             products are plain (not photonic).

What a served request is: the batcher prefills the prompt but its last
token, right-padded with token 0 to the bucket, in one call of M = bucket
rows (the padding rows route in the MoE, and so take expert places), and
then decodes one token per call at the batch's M = slots rows, each row
its own call for the MoE's places.  A decoded token attends to the real
prompt positions and the decoded ones, not to the padding (which decoding
overwrites).  `Seq` describes one request so; `forward` gives the logits
of its decoded rows.

`Seq.force`, when given, adds a shadow of the last decoded row: the same
token at the same position, seeing what that row sees, whose MoE choices
at each layer are the given ones and not the reference's own (the
reference then follows a router's choices for one step, the rest of the
sequence as it routes itself); its logits follow the others.

`act`, when given, rounds the input of every product (every linear, the
experts, and attention's q, k, v and probabilities) as a lower precision
would: the control of the check.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

BANK = 128
f32 = torch.float32


@dataclass
class Seq:
    prefill: List[int]      # the padded prefill call's tokens
    n_real: int             # of them, the prompt's (the rest is padding)
    decode: List[int]       # one token per decode call, in order
    m_prefill: int          # rows of the prefill call's products
    m_decode: int           # rows of a decode call's products
    force: Optional[torch.Tensor] = None    # (layers, top_k) experts of a shadow row


def tiled(m: int, k: int, n: int) -> bool:
    """True when a product of m rows by a (k, n) weight takes one scale
    per bank (else one per column)."""
    return not (m % BANK or k % BANK or n % BANK)


def quant_bank(w: torch.Tensor, bits: int) -> torch.Tensor:
    k, n = w.shape
    qmax = 2 ** (bits - 1) - 1
    tiles = w.reshape(k // BANK, BANK, n // BANK, BANK)
    scale = tiles.abs().amax(dim=(1, 3)).clamp_min(1e-8) / qmax
    s = scale[:, None, :, None]
    return (tiles / s).round_().clamp_(-qmax, qmax).mul_(s).reshape(k, n)


def quant_col(w: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    scale = w.abs().amax(dim=0).clamp_min(1e-8) / qmax
    return (w / scale).round_().clamp_(-qmax, qmax).mul_(scale)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (the control)."""
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(f32) * s


class _Weights:
    """One layer's weights as the products see them: f32, quantised by
    the call's rows, each variant made once."""

    def __init__(self, c: dict):
        self.c, self._cache = c, {}

    def get(self, w: torch.Tensor, m: int) -> torch.Tensor:
        """w (K, N) as a product of m rows sees it."""
        if not self.c["use_photonic_mac"]:
            return w.to(f32)
        bank = tiled(m, *w.shape)
        key = (w.data_ptr(), tuple(w.shape), bank)
        if key not in self._cache:
            q = quant_bank if bank else quant_col
            self._cache[key] = q(w.to(f32), self.c["photonic_bits"])
        return self._cache[key]


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.to(f32))


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D), pos (S,)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=f32, device=x.device) / d))
    ang = pos.to(f32)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _Rows:
    """One request's rows: the prefill call's, then the decode calls'."""

    def __init__(self, s: Seq, device):
        self.s = s
        self.n_pre = len(s.prefill)
        shadow = s.force is not None
        dec_ids = s.decode + s.decode[-1:] * shadow
        ids = torch.tensor(s.prefill + dec_ids, device=device)
        self.ids = ids
        self.step = len(ids) - 1 - shadow        # the last decoded row
        pre = torch.arange(self.n_pre, device=device)
        dec = s.n_real + torch.arange(len(s.decode), device=device)
        self.pos = torch.cat([pre, dec, dec[-1:].repeat(int(shadow))])
        is_dec = torch.arange(len(ids), device=device) >= self.n_pre
        qd, kd = is_dec[:, None], is_dec[None, :]
        idx = torch.arange(len(ids), device=device)
        before = idx[None, :] <= idx[:, None]
        # a prefill row sees the prefill rows up to itself; a decoded row
        # the real prompt rows and the decoded rows up to itself
        real = (idx < s.n_real)[None, :]
        self.mask = torch.where(qd, (~kd & real) | (kd & before), ~kd & before)
        if shadow:
            self.mask[-1, -2] = False


def _linear(x, rows: _Rows, w, W: _Weights, act):
    """x (S, K) of one request: its prefill rows and its decode rows are
    separate calls, each quantised by its own M."""
    n = rows.n_pre
    parts = []
    for part, m in ((x[:n], rows.s.m_prefill), (x[n:], rows.s.m_decode)):
        if len(part):
            parts.append(act(part) @ W.get(w, m))
    return torch.cat(parts)


def _attention(c, p, x, rows: _Rows, W, act, window: int):
    s, m = x.shape
    h, hk, d = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    xn = _rms(x, p["norm"], c["norm_eps"])
    q = _linear(xn, rows, p["wq"].reshape(m, h * d), W, act).reshape(s, h, d)
    k = _linear(xn, rows, p["wk"].reshape(m, hk * d), W, act).reshape(s, hk, d)
    v = _linear(xn, rows, p["wv"].reshape(m, hk * d), W, act).reshape(s, hk, d)
    q, k = _rope(q, rows.pos, c["rope_theta"]), _rope(k, rows.pos, c["rope_theta"])
    mask = rows.mask
    if window > 0:
        mask = mask & (rows.pos[None, :] > rows.pos[:, None] - window)
    g = h // hk
    out = torch.empty((s, h, d), dtype=f32, device=x.device)
    for j in range(hk):                        # one KV head's query group at a time
        qj = act(q[:, j * g:(j + 1) * g]).transpose(0, 1)          # (g, S, D)
        sc = qj @ act(k[:, j]).T * d ** -0.5                        # (g, S, S)
        sc = torch.where(mask[None], sc, torch.finfo(f32).min)
        pr = torch.softmax(sc, dim=-1)
        out[:, j * g:(j + 1) * g] = (act(pr) @ act(v[:, j])).transpose(0, 1)
    return x + _linear(out.reshape(s, h * d), rows, p["wo"].reshape(h * d, m), W, act)


def _swiglu(x, wg, wi, wo, act):
    g = torch.nn.functional.silu(act(x) @ wg)
    return act((act(x) @ wi) * g) @ wo


def _mlp(c, p, x, rows, W, act):
    xn = _rms(x, p["norm"], c["norm_eps"])
    g = torch.nn.functional.silu(_linear(xn, rows, p["wg"], W, act))
    hid = _linear(xn, rows, p["wi"], W, act) * g
    return x + _linear(hid, rows, p["wo"], W, act)


def top_k(probs: torch.Tensor, k: int):
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _kept(idx: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """idx (G, S, k) the experts of each call's tokens' choices -> which
    (token, choice) keep a place, in choices-major order within a call."""
    g, s, k = idx.shape
    onehot = torch.nn.functional.one_hot(idx.transpose(1, 2).reshape(g, k * s), e).to(f32)
    place = (onehot.cumsum(dim=1) - onehot) * onehot                 # (G, kS, E)
    keep = ((place < cap) * onehot).sum(-1) > 0                       # (G, kS)
    return keep.reshape(g, k, s).transpose(1, 2)                      # (G, S, k)


def _moe(c, p, x, rows: _Rows, W, act, experts, force=None, probs_out=None):
    """`force` (top_k,): the shadow row's experts; `probs_out`: a list that
    takes the router's probabilities at the last decoded row."""
    e, k, cf = c["n_experts"], c["top_k"], c["capacity_factor"]
    xn = _rms(x, p["norm"], c["norm_eps"])
    probs = torch.softmax(_linear(xn, rows, p["router"], W, act), dim=-1)
    gate, idx = top_k(probs, k)
    if force is not None:
        f = force.to(idx.device)
        idx = torch.cat([idx[:-1], f[None]])
        gate = torch.cat([gate[:-1], probs[-1].gather(0, f)[None]])
    if probs_out is not None:
        probs_out.append(probs[rows.step])
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    n = rows.n_pre
    keep = torch.cat([
        _kept(idx[None, :n], e, max(1, int(cf * n * k / e)))[0],      # the prefill call
        _kept(idx[n:, None], e, max(1, int(cf * 1 * k / e)))[:, 0],   # one call a decoded row
    ])
    y = torch.zeros_like(xn)
    for j in range(e):
        sel = (idx == j) & keep                                       # (S, k)
        tok = sel.any(-1).nonzero()[:, 0]
        if len(tok):
            wgt = (gate * sel).sum(-1)[tok, None]
            y.index_add_(0, tok, wgt * _swiglu(xn[tok], *experts[j], act))
    return x + y


def _stack(c: dict, params: dict):
    kind = "moe_0" if c["family"] == "moe" else "attn_0"
    return params["stages"][0][kind]


def _layer(tree, i):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}


@torch.no_grad()
def forward(c: dict, params: dict, seqs: List[Seq],
            act: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
            prefill_logits: bool = False, routes: Optional[list] = None):
    """The logits (f32, one row per decode call, then the shadow row's) of
    each request, layer by layer over all of them, so that one layer's f32
    weights are made at a time.  `c` is the configuration file's dict;
    `params` the drawn tree.  With `prefill_logits`, also those of each
    prefill call's last row (a product of one row, as the prefill call
    computes its head).  `routes`, a list, takes for each request the
    router's probabilities at its last decoded row, (layers, experts)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    act = act or (lambda t: t)
    if c["family"] not in ("dense", "moe"):
        raise ValueError(f"{c['name']}: no reference for family {c['family']!r}")
    window = c["window"] if c.get("attn_pattern") == "sliding" else 0
    dev = params["embed"].device
    rows = [_Rows(s, dev) for s in seqs]
    xs = [params["embed"][r.ids].to(f32) for r in rows]
    stack = _stack(c, params)
    probs = [[] for _ in seqs]
    for i in range(c["n_layers"]):
        p = _layer(stack, i)
        W = _Weights(c)
        xs = [_attention(c, p["attn"], x, r, W, act, window) for x, r in zip(xs, rows)]
        if c["family"] == "moe":
            m = p["moe"]
            experts = [tuple(m[n][j].to(f32) for n in ("wg", "wi", "wo"))
                       for j in range(c["n_experts"])]
            xs = [_moe(c, m, x, r, W, act, experts,
                       None if r.s.force is None else r.s.force[i], pr)
                  for x, r, pr in zip(xs, rows, probs)]
            del experts
        else:
            xs = [_mlp(c, p["mlp"], x, r, W, act) for x, r in zip(xs, rows)]
        del W
    out, pre = [], []
    head = _Weights(c)
    for x, r in zip(xs, rows):
        hd = _rms(x[r.n_pre:], params["final_norm"], c["norm_eps"])
        out.append(act(hd) @ head.get(params["lm_head"], r.s.m_decode))
        if prefill_logits:
            hp = _rms(x[r.n_pre - 1:r.n_pre], params["final_norm"], c["norm_eps"])
            pre.append(act(hp) @ head.get(params["lm_head"], 1))
    if routes is not None:
        routes.extend(torch.stack(p) if p else None for p in probs)
    return (out, pre) if prefill_logits else out
