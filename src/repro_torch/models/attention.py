"""Attention layers of the models: GQA (qwen3, stablelm, deepseek-7b, yi,
granite-moe-1b, llava's mistral backbone, hubert's encoder and
recurrentgemma-2b's local blocks) and MLA (deepseek-v2-236b):
projections, qk-norm, RoPE, and three attention paths.

* Full-sequence attention without a window (prefill, and the forward of
  an encoder or of a whole sequence), causal or not, runs K3, the Hopper
  flash-attention kernel, through :func:`repro_torch.kernels.ops.flash_attention`
  (its plain version for CPU tensors; the op pads head sizes the kernel
  is not built for, MLA's 192/128 and hubert's 80). The reference
  computes the same function with its chunked online-softmax scan; its
  docstring names the Pallas flash kernel as what plugs in there. Under
  autograd (training) the op's backward is K3-bwd, the port of the
  reference's ``_flash_grouped_bwd``.
* Windowed prefill and decode (MLA's absorbed decode too) run
  :func:`chunked_attention`, the reference's chunked online-softmax
  attention in plain PyTorch, as the reference runs them outside any
  Pallas kernel. In the reference's own case for its memory-safe VJP (no
  ``kv_valid_len``, an int ``q_offset``: a window's training forward and
  prefill) it runs through :class:`FlashGrouped`, whose backward
  recomputes P per chunk from the saved (q, k, v, out, lse) instead of
  keeping the (T, S) probabilities. Its chunk is ``kv_chunk``, or the
  ``REPRO_KV_CHUNK`` knob (:func:`repro_torch.launch.tuning.kv_chunk`)
  read at call time, as the reference reads it.
* Decode (GQA, the local ring buffer and MLA's latent MQA) first asks
  ``shardctx.get("decode_attention")``, the launcher's flash-decoding
  override (:mod:`repro_torch.launch.flash_decode`), and falls back to
  :func:`chunked_attention` when none is installed or it returns None.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_bwd_plain
from repro_torch.launch import tuning

from . import shardctx
from .layers import Params, apply_rope, dense_init, matmul, rmsnorm, rmsnorm_init

NEG_INF = -1e30


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


def _flash_fwd(q, k, v, causal, window, q_offset, kv_chunk, scale, kv_valid_len):
    """The reference's ``_flash_fwd``: the chunked online-softmax scan over
    KV in f32. Returns out (B, T, KV, G, Dv) f32 and lse (B, T, KV, G); a
    short last chunk is sliced, not padded (its keys past S do not exist)."""
    acc, m, denom = _flash_scan(q, k, v, causal, window, q_offset, kv_chunk, scale,
                                kv_valid_len)
    denom = torch.clamp(denom, min=1e-30)
    return acc / denom[..., None], m + torch.log(denom)


def _flash_scan(q, k, v, causal, window, q_offset, kv_chunk, scale, kv_valid_len):
    """The scan of :func:`_flash_fwd`, unnormalised: the numerator acc
    (B, T, KV, G, Dv), the running maximum m and the denominator
    (B, T, KV, G), all f32."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    qf = q.float().reshape(B, T, KV, G, D) * scale
    q_pos = torch.as_tensor(q_offset, device=q.device) + torch.arange(T, device=q.device)
    acc = torch.zeros((B, T, KV, G, Dv), dtype=torch.float32, device=q.device)
    m = torch.full((B, T, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((B, T, KV, G), dtype=torch.float32, device=q.device)
    for lo in range(0, S, kv_chunk):
        hi = min(lo + kv_chunk, S)
        kv_pos = torch.arange(lo, hi, device=q.device)
        s = torch.einsum("btkgd,bckd->btkgc", qf, k[:, lo:hi].float())
        s = s + _chunk_bias(q_pos, kv_pos, causal, window, kv_valid_len)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        denom = denom * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("btkgc,bckv->btkgv", p, v[:, lo:hi].float())
        m = m_new
    return acc, m, denom


class FlashGrouped(torch.autograd.Function):
    """The reference's ``_flash_grouped`` custom VJP: the forward is the
    chunked scan (:func:`_flash_fwd`) and keeps (q, k, v, out, lse); the
    backward (``_flash_grouped_bwd``: K3-bwd's plain version, with the
    window) recomputes p = exp(s - lse) chunk by chunk, so no (T, S)
    matrix is kept for it. Plain PyTorch: it serves windowed attention,
    which no kernel runs. Unlike the reference, which
    pads an S that is not a multiple of ``kv_chunk`` and then falls back to
    plain AD through ``_flash_fwd``, it covers that case too (the short last
    chunk sliced): the same function, the same gradient.
    ``FlashGrouped.apply(q, k, v, causal, window, q_offset, kv_chunk,
    scale)`` -> out (B, T, H, Dv) f32."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_chunk, scale):
        out, lse = _flash_fwd(q, k, v, causal, window, q_offset, kv_chunk, scale, None)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, kv_chunk, scale)
        B, T, H = q.shape[:3]
        return out.reshape(B, T, H, -1)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset, kv_chunk, scale = ctx.args
        B, T, KV, G, Dv = out.shape
        dq, dk, dv = flash_attention_bwd_plain(
            q, k, v, out.reshape(B, T, KV * G, Dv), lse.permute(0, 2, 3, 1).reshape(B, -1, T),
            dout, causal=causal, sm_scale=scale, kv_chunk=kv_chunk, window=window,
            q_offset=q_offset)
        return dq, dk, dv, None, None, None, None, None


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
    in q's dtype. The same steps as the reference's scan; with no
    ``kv_valid_len`` and an int ``q_offset`` (training and prefill) it runs
    through :class:`FlashGrouped`, whose backward is the reference's
    memory-safe one."""
    if kv_chunk is None:
        kv_chunk = tuning.kv_chunk()
    B, T, H, D = q.shape
    S = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kv_chunk = max(min(kv_chunk, S), 1)
    if kv_valid_len is None and isinstance(q_offset, int):
        out = FlashGrouped.apply(q, k, v, causal, window, q_offset, kv_chunk, scale)
    else:
        out = _flash_fwd(q, k, v, causal, window, q_offset, kv_chunk, scale,
                         kv_valid_len)[0].reshape(B, T, H, -1)
    return out.to(q.dtype)


def decode_partials(q, k, v, valid, scale):
    """The partials of one decode token's attention (q (B, 1, H, D)) over
    cache slots k (B, S, KV, D), v (B, S, KV, Dv) whose first ``valid``
    (B,) hold keys: :func:`chunked_attention`'s scan, in its chunks
    (``REPRO_KV_CHUNK``), unnormalised. Returns the numerator (B, 1, KV,
    G, Dv), the row maximum m and the denominator (B, 1, KV, G), f32;
    numerator / max(denominator, 1e-30) is ``chunked_attention``'s output
    to the last bit. A row with no valid slot has m = -1e30."""
    kv_chunk = max(min(tuning.kv_chunk(), k.shape[1]), 1)
    return _flash_scan(q, k, v, False, 0, 0, kv_chunk, scale, valid)


def _decode_attention(q, k, v, valid, scale):
    """One decode token's attention over the cache's ``valid`` slots: the
    launcher's ``decode_attention`` override (flash-decoding) when it is
    installed and takes the shapes, else :func:`chunked_attention`."""
    override = shardctx.get("decode_attention")
    out = override(q, k, v, valid, scale) if override is not None else None
    if out is None:
        out = chunked_attention(q, k, v, causal=False, kv_valid_len=valid, scale=scale)
    return out


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


def _sequence_attention(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    """A whole sequence's attention: K3 without a window, else the chunked
    scan."""
    if window > 0:
        return chunked_attention(q, k, v, causal=causal, window=window)
    return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)


def gqa_forward(
    x: torch.Tensor, p: Params, cfg, *, causal: bool = True, window: int = 0,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence forward (no cache returned)."""
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = _sequence_attention(q, k, v, causal=causal, window=window)
    return matmul(out.reshape(B, T, -1), p["wo"])


def gqa_prefill(
    x: torch.Tensor, p: Params, cfg, cache_len: int, *, window: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: forward + the KV cache padded/trimmed to ``cache_len``, in
    k's dtype. Windowless causal attention runs K3."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = matmul(_sequence_attention(q, k, v, causal=True, window=window).reshape(B, T, -1),
                 p["wo"])
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
    out = _decode_attention(q, k_cache, v_cache, valid, 1.0 / math.sqrt(cfg.head_dim))
    return matmul(out.reshape(B, 1, -1), p["wo"]), {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# MLA, Multi-head Latent Attention (deepseek-v2-236b)
#
# Prefill runs the expanded form through K3; decode the "absorbed" form
# over the compressed latent cache (c_kv 512 + k_rope 64 values a token),
# which is what makes MLA prefix blocks about 9x smaller than the
# MHA-equivalent in the shared KV cache.
# ---------------------------------------------------------------------------
def mla_init(gen: torch.Generator, cfg, dtype=torch.float32, device=None,
             lead: tuple = ()) -> Params:
    H = cfg.n_heads
    dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    R = cfg.kv_lora_rank
    return {
        # query path (low-rank as in DeepSeek-V2)
        "wq_a": dense_init(gen, cfg.d_model, cfg.q_lora_rank, dtype, device, lead),
        "q_a_norm": rmsnorm_init(cfg.q_lora_rank, dtype, device, lead),
        "wq_b": dense_init(gen, cfg.q_lora_rank, H * dq, dtype, device, lead),
        # kv path: compressed to the latent + a decoupled rope key
        "wkv_a": dense_init(gen, cfg.d_model, R + cfg.qk_rope_head_dim, dtype, device, lead),
        "kv_a_norm": rmsnorm_init(R, dtype, device, lead),
        "w_uk": dense_init(gen, R, H * cfg.qk_nope_head_dim, dtype, device, lead),
        "w_uv": dense_init(gen, R, H * cfg.v_head_dim, dtype, device, lead),
        "wo": dense_init(gen, H * cfg.v_head_dim, cfg.d_model, dtype, device, lead),
    }


def _mla_q(x, p, cfg, positions):
    B, T, _ = x.shape
    q = matmul(rmsnorm(matmul(x, p["wq_a"]), p["q_a_norm"], cfg.norm_eps), p["wq_b"])
    q = q.reshape(B, T, cfg.n_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    q_nope = q[..., : cfg.qk_nope_head_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(x, p, cfg, positions):
    """The compressed latent c_kv (B,T,R) and the rotary key k_rope
    (B,T,1,Dr), one head shared by all."""
    kv = matmul(x, p["wkv_a"])
    c_kv = rmsnorm(kv[..., : cfg.kv_lora_rank], p["kv_a_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., cfg.kv_lora_rank:][:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope


def _mla_expanded(x, p, cfg, causal, positions):
    """The expanded form: K and V per head from the latent, one K3 launch.
    Returns the output and the latent."""
    B, T, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(x, p, cfg, positions)
    c_kv, k_rope = _mla_latent(x, p, cfg, positions)
    k_nope = matmul(c_kv, p["w_uk"]).reshape(B, T, H, cfg.qk_nope_head_dim)
    v = matmul(c_kv, p["w_uv"]).reshape(B, T, H, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, T, H, cfg.qk_rope_head_dim)], dim=-1)
    out = ops.flash_attention(q, k, v.contiguous(), causal=causal)   # scale 1/sqrt(192)
    return matmul(out.reshape(B, T, -1), p["wo"]), c_kv, k_rope


def mla_forward(
    x: torch.Tensor, p: Params, cfg, *, causal: bool = True,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence forward, expanded K/V."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return _mla_expanded(x, p, cfg, causal, positions)[0]


def mla_prefill(
    x: torch.Tensor, p: Params, cfg, cache_len: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: the causal forward and the latent cache padded/trimmed to
    ``cache_len`` (the reference computes the latent twice, the same
    values)."""
    T = x.shape[1]
    out, c_kv, k_rope = _mla_expanded(x, p, cfg, True, torch.arange(T, device=x.device))
    pad = max(cache_len - T, 0)
    cache = {
        "c_kv": torch.nn.functional.pad(c_kv[:, :cache_len], (0, 0, 0, pad)),
        "k_rope": torch.nn.functional.pad(k_rope[:, :cache_len, 0, :], (0, 0, 0, pad)),
    }
    return out, cache


def mla_decode_step(
    x: torch.Tensor,            # (B, 1, d)
    p: Params,
    cfg,
    cache: Dict[str, torch.Tensor],   # c_kv (B,S,R), k_rope (B,S,Dr)
    position: torch.Tensor,     # (B,)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-form decode: attention runs in the latent space.

    score_h(s) = q_nope_h . (W_uk_h c_s) + q_rope_h . k_rope_s
               = (W_uk_h^T q_nope_h) . c_s + q_rope_h . k_rope_s
    out_h = (sum_s p_s c_s) @ W_uv_h

    The new latent row is written into ``cache`` in place (cast to the
    cache's dtype) and the same tensors are returned.
    """
    B = x.shape[0]
    H, R = cfg.n_heads, cfg.kv_lora_rank
    position = position.to(x.device)
    q_nope, q_rope = _mla_q(x, p, cfg, position[:, None])           # (B,1,H,*)
    c_new, k_rope_new = _mla_latent(x, p, cfg, position[:, None])
    batch_idx = torch.arange(B, device=x.device)
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    c_cache[batch_idx, position] = c_new[:, 0].to(c_cache.dtype)
    r_cache[batch_idx, position] = k_rope_new[:, 0, 0].to(r_cache.dtype)

    w_uk = p["w_uk"].reshape(R, H, cfg.qk_nope_head_dim)
    dt = torch.promote_types(q_nope.dtype, w_uk.dtype)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(dt), w_uk.to(dt))   # absorb W_uk
    # latent MQA: queries (B,H,R+Dr) against keys (B,S,R+Dr), one kv head
    q_cat = torch.cat([q_lat, q_rope[:, 0].to(dt)], dim=-1)[:, None]
    k_cat = torch.cat([c_cache, r_cache], dim=-1)[:, :, None, :]
    # the scores are the expanded form's dot products, whose query width
    # is nope + rope, not the latent's
    mla_scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    o_lat = _decode_attention(q_cat, k_cat, c_cache[:, :, None, :], position + 1,
                              mla_scale)                                # (B,1,H,R)
    w_uv = p["w_uv"].reshape(R, H, cfg.v_head_dim)
    dt = torch.promote_types(o_lat.dtype, w_uv.dtype)
    out = torch.einsum("bhr,rhv->bhv", o_lat[:, 0].to(dt), w_uv.to(dt)).reshape(B, 1, -1)
    return matmul(out, p["wo"]), {"c_kv": c_cache, "k_rope": r_cache}
