"""GQA attention layer of the models (qwen3, stablelm, deepseek-7b, yi,
granite-moe-1b, and recurrentgemma-2b's local blocks): projections,
qk-norm, RoPE, and three attention paths.

* Prefill with full (windowless) causal attention runs K3, the Hopper
  flash-attention kernel, through :func:`repro_torch.kernels.ops.flash_attention`
  (its plain version for CPU tensors). The reference computes the same
  function with its chunked online-softmax scan; its docstring names the
  Pallas flash kernel as what plugs in there.
* Windowed prefill and decode run :func:`chunked_attention`, the
  reference's chunked online-softmax attention in plain PyTorch, as the
  reference runs them outside any Pallas kernel.

Not ported here: MLA, the training VJP, and the launcher's ``shardctx``
decode override (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import ops

from .layers import Params, apply_rope, dense_init, matmul, rmsnorm, rmsnorm_init

NEG_INF = -1e30
KV_CHUNK = 1024     # the reference's default chunk (repro.launch.tuning.kv_chunk)


def _chunk_bias(q_pos, kv_pos, causal, window, kv_valid_len):
    """Additive log-bias (B or 1, T, 1, 1, c): 0 where attendable, NEG_INF
    elsewhere (twice NEG_INF where two masks agree, as in the reference)."""
    mask = torch.ones((q_pos.shape[-1], kv_pos.shape[0]), dtype=torch.bool, device=kv_pos.device)
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[..., :, None])
    if window > 0:
        mask = mask & (kv_pos[None, :] > q_pos[..., :, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=kv_pos.device)
    bias = torch.where(mask, zero, NEG_INF)[None, :, None, None, :]
    if kv_valid_len is not None:
        vmask = kv_pos[None, :] < kv_valid_len.to(kv_pos.device)[:, None]   # (B, c)
        bias = bias + torch.where(vmask, zero, NEG_INF)[:, None, None, None, :]
    return bias


def chunked_attention(
    q: torch.Tensor,            # (B, T, H, D)
    k: torch.Tensor,            # (B, S, KV, D)
    v: torch.Tensor,            # (B, S, KV, Dv)
    *,
    causal: bool = True,
    window: int = 0,            # >0: local attention (causal, last `window`)
    q_offset: Union[int, torch.Tensor] = 0,   # absolute position of q[0]
    kv_chunk: Optional[int] = None,
    kv_valid_len: Optional[torch.Tensor] = None,   # (B,) valid prefix of S
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks in f32. Returns (B, T, H, Dv)
    in q's dtype. The same steps as the reference's scan; a short last
    chunk is masked by ``kv_valid_len`` as the reference masks its padding."""
    if kv_chunk is None:
        kv_chunk = KV_CHUNK
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kv_chunk = min(kv_chunk, S)
    n_chunks = (S + kv_chunk - 1) // kv_chunk
    if n_chunks * kv_chunk != S and kv_valid_len is None:
        kv_valid_len = torch.full((B,), S, dtype=torch.int32, device=q.device)

    qf = q.float().reshape(B, T, KV, G, D) * scale
    q_pos = torch.as_tensor(q_offset, device=q.device) + torch.arange(T, device=q.device)
    acc = torch.zeros((B, T, KV, G, Dv), dtype=torch.float32, device=q.device)
    m = torch.full((B, T, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((B, T, KV, G), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        lo, hi = c * kv_chunk, min((c + 1) * kv_chunk, S)
        kv_pos = torch.arange(lo, hi, device=q.device)
        s = torch.einsum("btkgd,bckd->btkgc", qf, k[:, lo:hi].float())
        s = s + _chunk_bias(q_pos, kv_pos, causal, window, kv_valid_len)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        denom = denom * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("btkgc,bckv->btkgv", p, v[:, lo:hi].float())
        m = m_new
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return out.reshape(B, T, H, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------
def gqa_init(gen: torch.Generator, cfg, dtype=torch.float32, device=None,
             lead: tuple = ()) -> Params:
    hd = cfg.head_dim
    p: Params = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype, device, lead),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device, lead),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device, lead),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype, device, lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device, lead)
        p["k_norm"] = rmsnorm_init(hd, dtype, device, lead)
    return p


def _project_qkv(x, p, cfg, positions):
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = matmul(x, p["wq"]).reshape(B, T, cfg.n_heads, hd)
    k = matmul(x, p["wk"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = matmul(x, p["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.positional == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(
    x: torch.Tensor, p: Params, cfg, *, causal: bool = True, window: int = 0,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence forward (no cache returned)."""
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = chunked_attention(q, k, v, causal=causal, window=window)
    return matmul(out.reshape(B, T, -1), p["wo"])


def gqa_prefill(
    x: torch.Tensor, p: Params, cfg, cache_len: int, *, window: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: forward + the KV cache padded/trimmed to ``cache_len``, in
    k's dtype. Windowless causal attention runs K3."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)
    q, k, v = _project_qkv(x, p, cfg, positions)
    if window > 0:
        out = chunked_attention(q, k, v, causal=True, window=window)
    else:
        out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    out = matmul(out.reshape(B, T, -1), p["wo"])
    if window > 0:
        cache_len = min(cache_len, window)
        k_c, v_c = k[:, -cache_len:], v[:, -cache_len:]
    else:
        k_c, v_c = k[:, :cache_len], v[:, :cache_len]
    pad = max(cache_len - k_c.shape[1], 0)
    if pad:
        k_c = torch.nn.functional.pad(k_c, (0, 0, 0, 0, 0, pad))
        v_c = torch.nn.functional.pad(v_c, (0, 0, 0, 0, 0, pad))
    return out, {"k": k_c.contiguous(), "v": v_c.contiguous()}


def gqa_decode_step(
    x: torch.Tensor,            # (B, 1, d_model)
    p: Params,
    cfg,
    cache: Dict[str, torch.Tensor],
    position: torch.Tensor,     # (B,) current absolute position
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over a dense KV cache. Unlike the reference's
    functional ``.at[].set``, the new K/V row is written into ``cache`` in
    place (cast to the cache's dtype) and the same tensors are returned:
    a step does not copy the whole cache.

    Full attention: cache slot = position. Local attention: ring buffer of
    size ``window`` (slot = position % window).
    """
    B = x.shape[0]
    position = position.to(x.device)
    q, k, v = _project_qkv(x, p, cfg, position[:, None])
    S = cache["k"].shape[1]
    slot = position % max(window, 1) if window > 0 else position
    batch_idx = torch.arange(B, device=x.device)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[batch_idx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[batch_idx, slot] = v[:, 0].to(v_cache.dtype)
    # Ring buffer (window > 0): every resident slot is within the window
    # by construction; validity = min(position+1, window) slots.
    valid = torch.clamp(position + 1, max=S) if window > 0 else position + 1
    out = chunked_attention(q, k_cache, v_cache, causal=False, kv_valid_len=valid)
    return matmul(out.reshape(B, 1, -1), p["wo"]), {"k": k_cache, "v": v_cache}
