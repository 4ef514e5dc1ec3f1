"""Foundational layers of the model zoo: RMSNorm, RoPE, linear and
embedding initializers, the embedding lookup, the SwiGLU and GELU MLPs,
the causal depthwise conv1d of the RG-LRU blocks, the cross-entropy (and
both vocabulary-parallel). Functional, as in the reference
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
def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's temperature factor 0.1 mscale ln(factor) + 1 (1 unscaled)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None,
                     yarn: Tuple[float, ...] = ()) -> torch.Tensor:
    """The rotation's ``head_dim / 2`` frequencies. With ``yarn``
    (``ArchConfig.rope_yarn``), YaRN's as DeepSeek-V2 takes them
    (arXiv:2309.00071): a frequency that turns fewer than ``beta_slow``
    times over the original context is divided by ``factor``, one that
    turns more than ``beta_fast`` times is kept, and a linear ramp over
    the frequency index joins the two."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    if not yarn:
        return freqs
    factor, original, fast, slow = yarn[:4]

    def index(turns):   # the dimension at which a frequency turns this often
        return head_dim * math.log(original / (turns * 2 * math.pi)) / (2 * math.log(theta))

    lo, hi = max(math.floor(index(fast)), 0), min(math.ceil(index(slow)), head_dim - 1)
    ramp = (torch.arange(half, dtype=torch.float32, device=device) - lo) / max(hi - lo, 0.001)
    ramp = ramp.clamp(0, 1)
    return freqs / factor * ramp + freqs * (1 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
               yarn: Tuple[float, ...] = ()) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer.

    Split-half convention (as Llama/Qwen): rotate (x1, x2) ->
    (x1 cos - x2 sin, x2 cos + x1 sin). With ``yarn``, YaRN's frequencies
    and cos and sin times mscale(factor, mscale) / mscale(factor,
    mscale_all_dim).
    """
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device, yarn=yarn)
    angles = positions.to(x.device)[..., None].float() * freqs   # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]                       # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    if yarn:
        m = yarn_mscale(yarn[0], yarn[4]) / yarn_mscale(yarn[0], yarn[5])
        cos, sin = cos * m, sin * m
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


def model_parallel(family: str):
    """The ``shardctx`` rule ``"model_parallel"`` (a
    ``training.data_parallel.ModelParallel``) where it partitions
    ``family`` ("attn": GQA, "mla", "mlp": the dense MLP, "moe": the MoE
    layer, "rglru": the RG-LRU on its width, "mlstm" and "slstm": the xLSTM
    blocks on their heads, "vocab": the embedding and the head) over the
    ``model`` ranks, else None. Partitioned, a block's weights are this
    rank's columns (wq, wk, wv; wq_b, w_uk, w_uv; w_gate, w_up; the
    RG-LRU's and the mLSTM's products; the head's vocabulary), rows (wo,
    w_down, w_out, w_ff_up; the embedding's vocabulary), channels, heads
    or experts: its code calls the rule's ``enter`` on the replicated
    tensors the column products read and ``leave`` on the output of the
    row product or the masked lookup (the sum of the ranks' parts). The
    norms, the router, MLA's down-projections, MQA's KV head and the
    sLSTM's w_in and w_ff_down stay replicated."""
    mp = shardctx.get("model_parallel")
    return mp if mp is not None and family in mp.families else None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype,
                 parallel=None) -> torch.Tensor:
    """The rows of the embedding ``table`` (V, d) at ``tokens``, cast to
    ``dtype`` (the row gather first, then the cast: the same values as the
    reference's cast-then-gather). The gather is ``F.embedding``: its
    backward on CUDA sums each row's repeats in f32 and writes the row
    once, where an index's backward adds them into a bf16 table's row one
    rounding at a time (a Zipf-hot row's thousand repeats a step then lose
    about a tenth of its gradient). With ``parallel``
    (:func:`model_parallel` of "vocab"), ``table`` is this rank's rows
    [lo, lo + n) of the vocabulary: the tokens it owns are gathered, the
    others' rows zeroed, and the ranks' rows summed (``leave``: one
    all-reduce; exactly one rank gives each token a row that is not zero,
    so the sum is exact)."""
    if parallel is None:
        return F.embedding(tokens, table).to(dtype)
    n = table.shape[0]
    local = tokens - parallel.index * n
    owned = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table).to(dtype)
    return parallel.leave(torch.where(owned[..., None], rows, 0.0))


def mlp_apply(x: torch.Tensor, p: Params, parallel=None) -> torch.Tensor:
    """The SwiGLU MLP; with ``parallel`` (:func:`model_parallel`), on this
    rank's columns of it."""
    if parallel is not None:
        x = parallel.enter(x)
    gate = F.silu(matmul(x, p["w_gate"]))
    out = matmul(gate * matmul(x, p["w_up"]), p["w_down"])
    return out if parallel is None else parallel.leave(out)


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32,
                  device=None, lead: tuple = ()) -> Params:
    return {
        "w_up": dense_init(gen, d_model, d_ff, dtype, device, lead),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device, lead),
    }


def gelu_mlp_apply(x: torch.Tensor, p: Params, parallel=None) -> torch.Tensor:
    """The tanh-approximated GELU MLP (``jax.nn.gelu(approximate=True)``);
    with ``parallel``, on this rank's columns of it."""
    if parallel is not None:
        x = parallel.enter(x)
    out = matmul(F.gelu(matmul(x, p["w_up"]), approximate="tanh"), p["w_down"])
    return out if parallel is None else parallel.leave(out)


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
    batch's: the numerator and the count are summed over the ranks. With
    the vocabulary split over ``model``, :func:`vocab_parallel_cross_entropy`
    takes each rank's block of the logits instead."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return _masked_mean(lse, ll, mask, z_loss)


class _VocabParallelLse(torch.autograd.Function):
    """The log-sum-exp and the label's logit of each row of the whole
    logits, from this rank's f32 block of them (its vocabulary [lo, lo +
    n)), in ATen's ``logsumexp`` order: the block's row max, its maximum
    over the model group (MAX), an infinite max taken as 0, the sum of
    ``exp(x - max)`` over the block, packed with the label's logit (0 where
    another rank owns the label) into one SUM over the model group, then
    ``log(sum) + max``. At one rank that is ``torch.logsumexp`` and
    ``torch.gather`` bit for bit. The backward is their autograd's:
    ``g_lse exp(x - lse)``, plus ``g_ll`` at the label's column on the
    rank that owns it; no collective."""

    @staticmethod
    def forward(ctx, block, labels, mp):
        n = block.shape[-1]
        local = labels.long() - mp.index * n
        owned = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)[..., None]
        m = mp.max_(torch.amax(block, dim=-1, keepdim=True))
        m.masked_fill_(m.abs() == float("inf"), 0.0)
        ll = torch.where(owned, torch.gather(block, -1, local)[..., 0], 0.0)
        sums = mp.sum_(torch.stack([torch.sum(torch.exp(block - m), dim=-1), ll]))
        lse = torch.log(sums[0]).add_(m[..., 0])
        ctx.save_for_backward(block, lse, local, owned)
        return lse, sums[1].clone()

    @staticmethod
    def backward(ctx, g_lse, g_ll):
        block, lse, local, owned = ctx.saved_tensors
        grad = g_lse[..., None] * torch.exp(block - lse[..., None])
        grad.scatter_add_(-1, local, torch.where(owned, g_ll, 0.0)[..., None])
        return grad, None, None


def vocab_parallel_cross_entropy(block: torch.Tensor, labels: torch.Tensor, parallel,
                                 mask: Optional[torch.Tensor] = None,
                                 z_loss: float = 0.0) -> torch.Tensor:
    """:func:`softmax_cross_entropy` of the logits split over ``model`` on
    their vocabulary: ``block`` (..., V/m) is this rank's columns of them
    (``parallel``, :func:`model_parallel` of "vocab"), taken to f32. Two
    all-reduces over the model group (the row max; the exponentials' sum
    and the label's logit, packed) and none backward; no rank builds or
    gathers the whole (..., V) logits. The mask, ``z_loss`` and the data
    group's sums as the plain one's."""
    lse, ll = _VocabParallelLse.apply(block.float(), labels, parallel)
    return _masked_mean(lse, ll, mask, z_loss)


def _masked_mean(lse: torch.Tensor, ll: torch.Tensor, mask: Optional[torch.Tensor],
                 z_loss: float) -> torch.Tensor:
    """The cross-entropies ``lse - ll`` (with ``z_loss``) averaged over the
    masked positions, over the global batch under a data-parallel step."""
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
