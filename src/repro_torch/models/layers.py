"""Foundational layers of the model zoo: RMSNorm, RoPE, linear and
embedding initializers, the SwiGLU and GELU MLPs, the causal depthwise
conv1d of the RG-LRU blocks, the cross-entropy. Functional, as in the reference
(``repro.models.layers``): parameters are plain dicts of tensors and the
apply functions take them explicitly.

Products follow JAX's type promotion: ``x @ W`` with a bf16 ``x`` and an
f32 ``W`` is an f32 product (``torch.matmul`` refuses mixed types, so
:func:`matmul` casts both sides to the promoted type first).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import shardctx

Params = Dict[str, torch.Tensor]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the type JAX promotes the pair to (bf16 @ f32 -> f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# Initializers. The same distributions as the reference; a torch.Generator
# does not give jax.random's bits, so tests carry JAX parameters across
# (repro_torch.models.convert) instead of comparing inits.
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype=torch.float32,
               device=None, lead: tuple = ()) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) truncated at +-2, times
    1/sqrt(in_dim). ``lead`` prepends axes (a stack of layers, of
    experts). Drawn one (in_dim, out_dim) matrix at a time in f32, so a
    large stack in bf16 never has an f32 copy (deepseek-v2's routed
    experts of 4 layers: 5 G elements)."""
    w = torch.empty(lead + (in_dim, out_dim), dtype=dtype, device=device)
    f32 = torch.empty((in_dim, out_dim), dtype=torch.float32, device=device)
    for m in w.view(-1, in_dim, out_dim):
        torch.nn.init.trunc_normal_(f32, 0.0, 1.0, -2.0, 2.0, generator=gen)
        m.copy_(f32.mul_(1.0 / math.sqrt(in_dim)))
    return w


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    # 1/sqrt(dim) scale keeps tied-head logits O(1) at init.
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32, device=device)
    return (w / math.sqrt(dim)).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm (+ per-head qk-norm)
# ---------------------------------------------------------------------------
def rmsnorm_init(dim: int, dtype=torch.float32, device=None, lead: tuple = ()) -> Params:
    return {"scale": torch.ones(lead + (dim,), dtype=dtype, device=device)}


def rmsnorm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer.

    Split-half convention (as Llama/Qwen): rotate (x1, x2) ->
    (x1 cos - x2 sin, x2 cos + x1 sin).
    """
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions.to(x.device)[..., None].float() * freqs   # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]                       # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP (the FFN of every dense arch)
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32,
             device=None, lead: tuple = ()) -> Params:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device, lead),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device, lead),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device, lead),
    }


def mlp_apply(x: torch.Tensor, p: Params) -> torch.Tensor:
    gate = F.silu(matmul(x, p["w_gate"]))
    return matmul(gate * matmul(x, p["w_up"]), p["w_down"])


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32,
                  device=None, lead: tuple = ()) -> Params:
    return {
        "w_up": dense_init(gen, d_model, d_ff, dtype, device, lead),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device, lead),
    }


def gelu_mlp_apply(x: torch.Tensor, p: Params) -> torch.Tensor:
    """The tanh-approximated GELU MLP (``jax.nn.gelu(approximate=True)``)."""
    return matmul(F.gelu(matmul(x, p["w_up"]), approximate="tanh"), p["w_down"])


# ---------------------------------------------------------------------------
# Causal temporal conv1d (RG-LRU blocks)
# ---------------------------------------------------------------------------
def conv1d_init(gen: torch.Generator, width: int, kernel: int, dtype=torch.float32,
                device=None, lead: tuple = ()) -> Params:
    w = torch.empty(lead + (kernel, width), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return {"w": (w * (1.0 / math.sqrt(kernel))).to(dtype),
            "b": torch.zeros(lead + (width,), dtype=dtype, device=device)}


def causal_conv1d(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Depthwise causal conv. x: (B, T, W); kernel (K, W). K shifted adds,
    as the reference computes it."""
    k, T = p["w"].shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + T, :] * p["w"][i]
    return out + p["b"]


def causal_conv1d_step(x_t: torch.Tensor, state: torch.Tensor,
                       p: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. x_t: (B, W); state: (B, K-1, W) past inputs.
    Returns the output (B, W) and the new state."""
    window = torch.cat([state, x_t[:, None, :]], dim=1)                 # (B, K, W)
    dt = torch.promote_types(window.dtype, p["w"].dtype)
    out = torch.einsum("bkw,kw->bw", window.to(dt), p["w"].to(dt)) + p["b"]
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over the masked positions; logits (..., V) are
    taken to f32 first, labels (...) are integer ids. Under a data-parallel
    train step (``shardctx`` ``"data_parallel"``) the mean is the global
    batch's: the numerator and the count are summed over the ranks."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss > 0.0:
        loss = loss + z_loss * lse.square()
    dp = shardctx.get("data_parallel")
    if mask is None:
        if dp is None:
            return loss.mean()
        mask = torch.ones_like(loss)
    mask = mask.float()
    num, count = (loss * mask).sum(), mask.sum()
    if dp is not None:
        num, count = dp.all_sum(num), dp.sum_(count)
    return num / torch.clamp(count, min=1.0)
