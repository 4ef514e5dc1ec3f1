"""The models of the configuration files, in plain PyTorch, over the
parameters of ``harness/weights.py`` (a {path: tensor} map).

The published block: RMSNorm, GQA with an optional per-head RMSNorm of q
and k, split-half RoPE, causal softmax attention at 1/sqrt(head_dim), a
SwiGLU MLP or a top-k MoE of SwiGLU experts, a tied head, and the mean
next-token cross-entropy. The MoE follows what the configuration states
under ``assumed``: softmax router in f32, the top k (ties to the lower
index) renormalised, each expert taking at most round(capacity_factor x
k x tokens / E) choices in token order, choice by choice, and a
load-balance loss E x sum_e f_e m_e (f_e: top-1 share, m_e: mean
probability) weighted by ``router_aux_loss_coef``.

Every product runs in ``dtype`` (float32 for the reference, with TF32
off) unless ``quant`` is given: a function applied to both operands of
every product, which is how the control computes in a lower precision.
Attention runs in blocks of query rows, and training layers under
``torch.utils.checkpoint``, so that the reference fits beside nothing
else on the card.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 512


def _mm(x, w, quant):
    if quant is not None:
        x, w = quant(x), quant(w)
    return x @ w


def rmsnorm(x, scale, eps):
    x32 = x.float()
    out = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def rope(x, positions, theta):
    """x (B, T, heads, D): split-half rotation at ``positions`` (T,)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half))
    ang = positions.to(torch.float64)[:, None] * freqs[None, :]
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, quant):
    """Causal GQA softmax attention, q (B, T, H, D), k and v (B, T, KV, D),
    in blocks of Q_BLOCK query rows."""
    B, T, H, D = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2).permute(0, 2, 3, 1)       # (B, H, D, T)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)           # (B, H, T, D)
    q = q.transpose(1, 2) * (1.0 / math.sqrt(D))                # (B, H, T, D)
    outs = []
    for lo in range(0, T, Q_BLOCK):
        hi = min(lo + Q_BLOCK, T)
        s = _mm(q[:, :, lo:hi], k[..., :hi], quant)             # (B, H, rows, hi)
        rows = torch.arange(lo, hi, device=q.device)[:, None]
        keep = torch.arange(hi, device=q.device)[None, :] <= rows
        s = s.masked_fill(~keep, float("-inf"))
        p = torch.softmax(s.float(), dim=-1).to(q.dtype)
        outs.append(_mm(p, v[:, :, :hi], quant))
    return torch.cat(outs, dim=2).transpose(1, 2)               # (B, T, H, D)


def swiglu(x, wg, wu, wd, quant):
    return _mm(F.silu(_mm(x, wg, quant)) * _mm(x, wu, quant), wd, quant)


def moe(x, p, c, quant):
    """(out (N, d), aux) of the MoE layer over tokens x (N, d)."""
    a = c["assumed"]
    E, k = c["num_local_experts"], c["num_experts_per_tok"]
    N = x.shape[0]
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)          # (N, E) f32
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = vals[:, :k], idx[:, :k]
    if a.get("norm_topk_prob", True):
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    f_e = F.one_hot(top_i[:, 0], E).float().mean(0)
    aux = E * torch.sum(f_e * probs.mean(0))
    C = int(max(1, round(a["capacity_factor"] * k * N / E)))
    counts = torch.zeros(E, dtype=torch.int64, device=x.device)
    keep = torch.zeros((N, k), dtype=torch.bool, device=x.device)
    for j in range(k):              # choice j of every token, in token order
        oh = F.one_hot(top_i[:, j], E)
        before = torch.cumsum(oh, 0) - oh + counts
        keep[:, j] = before.gather(1, top_i[:, j:j + 1])[:, 0] < C
        counts = counts + oh.sum(0)
    out = torch.zeros((N, x.shape[1]), dtype=torch.float32, device=x.device)
    for e in range(E):
        tok, choice = torch.nonzero((top_i == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(x[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e], quant)
        out.index_add_(0, tok, y.float() * top_w[tok, choice][:, None])
    return out.to(x.dtype), aux


def layer(x, p: Dict[str, torch.Tensor], c: dict, positions, quant, tap=None):
    """One block: x + attention, then + MLP or MoE. Returns (x, aux). With
    ``tap`` ({"rows": positions, "k": [], "v": []}), appends the block's
    keys (normed and rotated) and values of the first sequence at those
    rows: what a KV cache holds."""
    B, T, d = x.shape
    H, KV, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    eps = c["rms_norm_eps"]
    h = rmsnorm(x, p["ln1/scale"], eps)
    q = _mm(h, p["attn/wq"], quant).reshape(B, T, H, hd)
    k = _mm(h, p["attn/wk"], quant).reshape(B, T, KV, hd)
    v = _mm(h, p["attn/wv"], quant).reshape(B, T, KV, hd)
    if c.get("qk_norm"):
        q = rmsnorm(q, p["attn/q_norm/scale"], eps)
        k = rmsnorm(k, p["attn/k_norm/scale"], eps)
    q, k = rope(q, positions, c["rope_theta"]), rope(k, positions, c["rope_theta"])
    if tap is not None:
        tap["k"].append(k[0, tap["rows"]])
        tap["v"].append(v[0, tap["rows"]])
    o = attention(q, k, v, quant).reshape(B, T, H * hd)
    x = x + _mm(o, p["attn/wo"], quant)
    h2 = rmsnorm(x, p["ln2/scale"], eps)
    if c.get("num_local_experts"):
        y, aux = moe(h2.reshape(B * T, d), {n[4:]: t for n, t in p.items()
                                           if n.startswith("ffn/")}, c, quant)
        return x + y.reshape(B, T, d), aux
    y = swiglu(h2, p["ffn/w_gate"], p["ffn/w_up"], p["ffn/w_down"], quant)
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)


def layer_params(params: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer i's leaves (the stacked ``blocks/g0/...`` sliced at i)."""
    pre = "blocks/g0/"
    return {n[len(pre):]: t[i] for n, t in params.items() if n.startswith(pre)}


def hidden(params, c: dict, tokens, *, quant: Optional[Callable] = None, remat: bool = False,
           tap=None):
    """The final hidden states (B, T, d), after the final norm, and the
    sum of the MoE aux losses (``tap``: as :func:`layer`'s, every layer)."""
    dtype = params["embed"].dtype
    x = params["embed"][tokens].to(dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(c["num_hidden_layers"]):
        p = layer_params(params, i)
        if remat:
            x, a = checkpoint(layer, x, p, c, positions, quant, use_reentrant=False)
        else:
            x, a = layer(x, p, c, positions, quant, tap)
        aux = aux + a
    return rmsnorm(x, params["final_norm/scale"], c["rms_norm_eps"]), aux


def head(params, c: dict, x, quant: Optional[Callable] = None):
    w = params["embed"].T if c.get("tie_word_embeddings") else params["lm_head"]
    return _mm(x, w, quant)


def loss(params, c: dict, batch, *, quant: Optional[Callable] = None, remat: bool = True):
    """Mean next-token cross-entropy (f32), plus the MoE's weighted aux loss."""
    x, aux = hidden(params, c, batch["tokens"], quant=quant, remat=remat)
    logits = head(params, c, x, quant).float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), batch["labels"].reshape(-1))
    coef = c.get("assumed", {}).get("router_aux_loss_coef", 0.0) if c.get(
        "num_local_experts") else 0.0
    return ce + coef * aux


def logits_at(params, c: dict, tokens, positions, *, quant: Optional[Callable] = None,
              kv: bool = False):
    """f32 logits (len(positions), V) of one sequence ``tokens`` (T,) at
    ``positions``: what the model predicts after each of those tokens.
    With ``kv``, (logits, k, v): every layer's keys and values at those
    positions, (layers, len(positions), kv heads, head_dim) each."""
    tap = {"rows": positions, "k": [], "v": []} if kv else None
    with torch.no_grad():
        x, _ = hidden(params, c, tokens[None, :], quant=quant, tap=tap)
        logits = head(params, c, x[0, positions], quant).float()
    if not kv:
        return logits
    return logits, torch.stack(tap["k"]), torch.stack(tap["v"])
