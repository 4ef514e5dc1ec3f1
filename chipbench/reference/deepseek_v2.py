"""DeepSeek-V2 (arXiv:2405.04434) in plain PyTorch, over the parameters of
``harness/weights.py`` (a {path: tensor} map), as a configuration file
states it: one chip's share of the model (its layers, its held experts,
its slice of the vocabulary).

The block, as published: RMSNorm; multi-head latent attention (q through
``wq_a``, RMSNorm and ``wq_b`` into 128 nope + 64 rope columns a head;
the latent ``wkv_a`` into 512 + 64, the 512 through RMSNorm and then
``w_uk`` to each head's nope key and ``w_uv`` to its value, the 64
rotated into the one rope key every head shares; the rotation's
frequencies and the causal softmax's scale, 1/sqrt(nope + rope), as the
file's ``rope_scaling`` (YaRN) sets them); then the first
``first_k_dense_replace`` layers a dense SwiGLU of ``intermediate_size``,
the others an MoE: softmax scores in f32 over the router's published
experts, group-limited greedy top-k
(the experts in ``n_group`` groups, a group scored by its best expert,
the ``topk_group`` best groups kept, the k best of their experts taken;
ties to the lower index), the weights not renormalised and times
``routed_scaling_factor``, the experts this chip holds and the shared
experts (one SwiGLU of ``n_shared_experts`` x ``moe_intermediate_size``)
counted once. The loss: the mean next-token cross-entropy over the
untied head, plus ``aux_loss_alpha`` x each MoE layer's sequence-wise
balance loss, sum_i f_i P_i of each sequence (f_i = E / (k T) x the
sequence's choices of expert i, P_i its mean score of i) averaged over
the sequences.

Departures (also the configuration's ``departures``): split-half RoPE
where the paper interleaves (a fixed permutation of q's and k's rope
columns); a per-expert capacity, round(capacity_factor x k x tokens / E),
whose overflow in token order, choice by choice, is dropped, where the
paper drops by device; the device-level and communication balance losses
left out; the experts other chips hold left out, their choices adding
nothing.

Products run in the parameters' dtype (float32 for the reference, with
TF32 off), or with both operands through ``quant``. Attention runs in
blocks of query rows, each under ``torch.utils.checkpoint`` while a
gradient is taken, and every training layer under checkpoint, so that
the reference fits beside its f32 state and no more.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .model import _mm, rmsnorm, rope, swiglu

Q_BLOCK = 256
DENSE, MOE = "dense/", "blocks/g0/"


def _scores_block(q, k, v, lo: int, quant):
    """Rows ``lo ..`` of causal attention: q (B, H, rows, D) already
    scaled, k (B, H, D, S), v (B, H, S, Dv) with S = lo + rows."""
    s = _mm(q, k, quant).float()
    rows = torch.arange(lo, lo + q.shape[2], device=q.device)[:, None]
    keep = torch.arange(k.shape[-1], device=q.device)[None, :] <= rows
    p = torch.softmax(s.masked_fill_(~keep, float("-inf")), dim=-1).to(q.dtype)
    return _mm(p, v, quant)


def attention(q, k, v, quant, scale: float):
    """Causal softmax attention, q and k (B, T, H, D), v (B, T, H, Dv), at
    ``scale``, in blocks of Q_BLOCK query rows."""
    T = q.shape[1]
    q = q.transpose(1, 2) * scale                               # (B, H, T, D)
    k = k.permute(0, 2, 3, 1)                                   # (B, H, D, T)
    v = v.transpose(1, 2)                                       # (B, H, T, Dv)
    outs = []
    for lo in range(0, T, Q_BLOCK):
        hi = min(lo + Q_BLOCK, T)
        args = (q[:, :, lo:hi], k[..., :hi], v[:, :, :hi], lo, quant)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_scores_block, *args, use_reentrant=False))
        else:
            outs.append(_scores_block(*args))
    return torch.cat(outs, dim=2).transpose(1, 2)               # (B, T, H, Dv)


def _yarn_get_mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def rotary(x, positions, c: dict):
    """x (B, T, heads, dr) rotated split-half at ``positions`` (T,): plain
    RoPE at ``rope_theta``, or with ``rope_scaling`` YaRN's cos and sin as
    DeepSeek-V2's modelling code builds them (``yarn_find_correction_range``,
    ``yarn_linear_ramp_mask``, ``yarn_get_mscale``)."""
    rs, base = c["rope_scaling"], float(c["rope_theta"])
    if rs is None:
        return rope(x, positions, base)
    dim = x.shape[-1]
    f64 = dict(dtype=torch.float64, device=x.device)
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, **f64) / dim))
    freq_inter = 1.0 / (rs["factor"] * base ** (torch.arange(0, dim, 2, **f64) / dim))

    def correction_dim(num_rotations):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (num_rotations * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    inv_freq_mask = 1.0 - torch.clamp((torch.arange(dim // 2, **f64) - low) / (high - low), 0, 1)
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    ang = positions.to(torch.float64)[:, None] * inv_freq[None, :]
    m = (_yarn_get_mscale(rs["factor"], rs["mscale"])
         / _yarn_get_mscale(rs["factor"], rs["mscale_all_dim"]))
    cos = (torch.cos(ang) * m).to(x.dtype)[None, :, None, :]
    sin = (torch.sin(ang) * m).to(x.dtype)[None, :, None, :]
    half = dim // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softmax_scale(c: dict) -> float:
    """1/sqrt(nope + rope), times yarn_get_mscale(factor, mscale_all_dim)^2
    under YaRN."""
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    rs = c["rope_scaling"]
    if rs is not None:
        scale *= _yarn_get_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def mla(h, p, c: dict, positions, quant, tap=None):
    """Multi-head latent attention of ``h`` (B, T, d), expanded: (B, T, d).
    With ``tap``, appends the latent rows of the first sequence (what a
    cache holds)."""
    B, T, _ = h.shape
    H, dn, dr, dv = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                     c["v_head_dim"])
    eps = c["rms_norm_eps"]
    q_lat = rmsnorm(_mm(h, p["attn/wq_a"], quant), p["attn/q_a_norm/scale"], eps)
    q = _mm(q_lat, p["attn/wq_b"], quant).reshape(B, T, H, dn + dr)
    q = torch.cat([q[..., :dn], rotary(q[..., dn:], positions, c)], dim=-1)
    kv = _mm(h, p["attn/wkv_a"], quant)
    R = c["kv_lora_rank"]
    c_kv = rmsnorm(kv[..., :R], p["attn/kv_a_norm/scale"], eps)
    k_rope = rotary(kv[..., R:][:, :, None, :], positions, c)   # (B, T, 1, dr)
    if tap is not None:
        tap["c_kv"].append(c_kv[0, tap["rows"]])
        tap["k_rope"].append(k_rope[0, tap["rows"], 0])
    k_nope = _mm(c_kv, p["attn/w_uk"], quant).reshape(B, T, H, dn)
    v = _mm(c_kv, p["attn/w_uv"], quant).reshape(B, T, H, dv)
    k = torch.cat([k_nope, k_rope.expand(B, T, H, dr)], dim=-1)
    o = attention(q, k, v, quant, softmax_scale(c)).reshape(B, T, H * dv)
    return _mm(o, p["attn/wo"], quant)


def experts(c: dict) -> tuple:
    """(E, first, held): the router's published experts, and the ones this
    chip holds, from ``first``."""
    return (c["published"]["n_routed_experts"], c["deployment"]["first_expert"],
            c["n_routed_experts"])


def route(h, router, c: dict):
    """(scores (N, E) f32, weights (N, k), experts (N, k)) of tokens ``h``
    (N, d): group-limited greedy top-k over softmax scores."""
    E = experts(c)[0]
    G, TG, k = c["n_group"], c["topk_group"], c["num_experts_per_tok"]
    scores = torch.softmax(h.float() @ router.float(), dim=-1)
    N = scores.shape[0]
    best = scores.reshape(N, G, E // G).amax(-1)
    _, order = torch.sort(best, dim=-1, descending=True, stable=True)
    groups = torch.zeros((N, G), dtype=torch.bool, device=h.device)
    groups.scatter_(1, order[:, :TG], True)
    masked = scores.masked_fill(~groups.repeat_interleave(E // G, dim=1), 0.0)
    w, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    if c["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    return scores, w * c["routed_scaling_factor"], idx


def kept(idx, c: dict):
    """(N, k) bool: each choice within its expert's capacity, the choices
    taken in token order, choice j of every token before choice j + 1."""
    E = experts(c)[0]
    N, k = idx.shape
    C = int(max(1, round(c["assumed"]["capacity_factor"] * k * N / E)))
    counts = torch.zeros(E, dtype=torch.int64, device=idx.device)
    keep = torch.zeros((N, k), dtype=torch.bool, device=idx.device)
    for j in range(k):
        oh = F.one_hot(idx[:, j], E)
        before = torch.cumsum(oh, 0) - oh + counts
        keep[:, j] = before.gather(1, idx[:, j:j + 1])[:, 0] < C
        counts = counts + oh.sum(0)
    return keep


def seq_balance(scores, idx, T: int):
    """sum_i f_i P_i of each sequence of T tokens, averaged over them."""
    N, E = scores.shape
    k = idx.shape[1]
    losses = []
    for s in range(N // T):
        rows = slice(s * T, (s + 1) * T)
        f = torch.bincount(idx[rows].reshape(-1), minlength=E).to(scores.dtype) * (E / (k * T))
        losses.append((f * scores[rows].mean(0)).sum())
    return torch.stack(losses).mean()


def routed(x, p, c: dict, quant, first: Optional[int] = None, held: Optional[int] = None):
    """(routed experts' output (N, d) f32, scores, choices) of tokens ``x``
    (N, d): the part experts ``first .. first + held - 1`` give (by
    default the configuration's), the weights ``p`` holds being theirs."""
    _, f0, n0 = experts(c)
    first, held = (f0 if first is None else first), (n0 if held is None else held)
    scores, w, idx = route(x, p["router"], c)
    keep = kept(idx, c)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(first, first + held):
        tok, choice = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        i = e - first
        y = swiglu(x[tok], p["w_gate"][i], p["w_up"][i], p["w_down"][i], quant)
        out.index_add_(0, tok, y.float() * w[tok, choice][:, None])
    return out, scores, idx


def shared(x, p, quant):
    return swiglu(x, p["shared/w_gate"], p["shared/w_up"], p["shared/w_down"], quant)


def moe(x, p, c: dict, quant, T: int):
    """(output (N, d), balance loss) of the MoE layer over tokens x (N, d),
    sequences of T: the held experts' part plus the shared experts'."""
    out, scores, idx = routed(x, p, c, quant)
    return (out + shared(x, p, quant).float()).to(x.dtype), seq_balance(scores, idx, T)


def layer(x, p: Dict[str, torch.Tensor], dense: bool, c: dict, positions, quant, tap=None):
    """One block: x + MLA, then + the dense MLP or the MoE. Returns (x, aux)."""
    B, T, d = x.shape
    eps = c["rms_norm_eps"]
    x = x + mla(rmsnorm(x, p["ln1/scale"], eps), p, c, positions, quant, tap)
    h = rmsnorm(x, p["ln2/scale"], eps)
    if dense:
        y = swiglu(h, p["ffn/w_gate"], p["ffn/w_up"], p["ffn/w_down"], quant)
        return x + y, torch.zeros((), dtype=torch.float32, device=x.device)
    y, aux = moe(h.reshape(B * T, d), {n[4:]: t for n, t in p.items() if n.startswith("ffn/")},
                 c, quant, T)
    return x + y.reshape(B, T, d), aux


def layer_params(params: Dict[str, torch.Tensor]):
    """(dense, leaves) of every layer in order: the leading dense layers'
    stack (``dense/...``), then the MoE layers' (``blocks/g0/...``), each
    stack unbound into its layers (whose gradients the backward stacks
    once, where slicing would add a stack-sized gradient a layer)."""
    out = []
    for pre, dense in ((DENSE, True), (MOE, False)):
        names = [n for n in params if n.startswith(pre)]
        if names:
            parts = {n[len(pre):]: torch.unbind(params[n]) for n in names}
            out += [(dense, {n: t[i] for n, t in parts.items()})
                    for i in range(len(parts[names[0][len(pre):]]))]
    return out


def hidden(params, c: dict, tokens, *, quant: Optional[Callable] = None, remat: bool = False,
           tap=None):
    """The final hidden states (B, T, d), after the final norm, and the sum
    of the MoE layers' balance losses."""
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for dense, p in layer_params(params):
        if remat:
            x, a = checkpoint(layer, x, p, dense, c, positions, quant, use_reentrant=False)
        else:
            x, a = layer(x, p, dense, c, positions, quant, tap)
        aux = aux + a
    return rmsnorm(x, params["final_norm/scale"], c["rms_norm_eps"]), aux


def loss(params, c: dict, batch, *, quant: Optional[Callable] = None, remat: bool = True):
    """Mean next-token cross-entropy (f32) plus aux_loss_alpha x the
    balance losses."""
    x, aux = hidden(params, c, batch["tokens"], quant=quant, remat=remat)
    logits = _mm(x, params["lm_head"], quant).float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), batch["labels"].reshape(-1))
    return ce + c["assumed"]["aux_loss_alpha"] * aux


def logits_at(params, c: dict, tokens, positions, *, quant: Optional[Callable] = None,
              kv: bool = False):
    """f32 logits (len(positions), V) of one sequence ``tokens`` (T,) at
    ``positions``. With ``kv``, (logits, c_kv, k_rope): every layer's
    latent rows at those positions, (layers, n, 512) and (layers, n, 64)."""
    tap = {"rows": positions, "c_kv": [], "k_rope": []} if kv else None
    with torch.no_grad():
        x, _ = hidden(params, c, tokens[None, :], quant=quant, tap=tap)
        logits = _mm(x[0, positions], params["lm_head"], quant).float()
    if not kv:
        return logits
    return logits, torch.stack(tap["c_kv"]), torch.stack(tap["k_rope"])
