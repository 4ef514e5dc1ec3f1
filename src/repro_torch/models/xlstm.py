"""xLSTM blocks (xlstm-125m, arXiv:2405.04517): mLSTM and sLSTM, the
reference's ``repro.models.xlstm`` in PyTorch.

* **mLSTM** (matrix memory): exponential input and forget gates over a
  rank-1-updated matrix state C_t = f_t C_{t-1} + i_t v_t k_t^T. A whole
  sequence runs the stabilized quadratic parallel form, or its
  chunkwise-parallel form (a loop over chunks carrying the scaled state);
  decode is the O(1) recurrent update.
* **sLSTM** (scalar memory, strictly sequential): exponential gating with
  the m-stabilizer state, heads independent (block-diagonal recurrent
  weights, (H, dh, dh)); a loop over time steps for a sequence, one step
  for decode.

The gates are computed in f32 with ``logsigmoid``, as in the reference;
its ``jax.nn.gelu`` calls take the tanh approximation. All of it is XLA
in the reference, outside any Pallas kernel, so its plain torch is the
port. The sLSTM's loop is one small step a token: launch-bound on the
card (ROADMAP.md names a scan kernel as later work).

Both blocks may be partitioned over the ``model`` ranks on their heads
(the ``shardctx`` rule ``"model_parallel"`` with the families ``"mlstm"``
and ``"slstm"``, :func:`~repro_torch.models.layers.model_parallel`):

* mLSTM: w_up and w_gate_up hold this rank's 2d/m columns, so it computes
  its channels of ``xu`` and ``z`` and the depthwise conv on them. q, k
  and the gates are dense products of the whole conv output, v of the
  whole ``xu``: one packed all-gather of the two a block (a reduce-scatter
  of their gradient backward) gives them whole, and wq, wk, wv, w_igate
  and w_fgate hold the columns of this rank's H/m heads. The recurrence
  runs on those heads; h is head-major, so its channels are the ``z``
  channels the rank holds. w_down's rows are summed over the ranks. The
  state (C, n, m) is this rank's heads, ``conv`` its channels.
* sLSTM: each rank takes its heads' four column blocks of the replicated
  w_in (a strided view, no communication; w_in's gradient is then summed
  over ``model`` by the train step) and runs the recurrence on its heads
  with r_i, r_f, r_z and r_o split on H. The normed h's channels times
  w_ff_up's rows give a partial (B, T, 2ff) summed over the ranks; the GLU
  and the replicated w_ff_down follow on every rank. The state (c, n, m,
  h) is this rank's heads.

Each block's ``out_norm`` normalises over its whole width: the rank's mean
of squares over its channels, summed over ``model`` and divided by m (one
all-reduce of (B, T, 1) forward and one of its gradient backward), which
at one rank is the plain ``rmsnorm``'s mean bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import (
    Params,
    causal_conv1d,
    causal_conv1d_step,
    conv1d_init,
    dense_init,
    matmul,
    model_parallel,
    rmsnorm,
    rmsnorm_init,
)

NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_init(gen: torch.Generator, cfg, dtype=torch.float32, device=None,
               lead: tuple = ()) -> Params:
    d = cfg.d_model
    up = 2 * d
    H = cfg.n_heads
    return {
        "w_up": dense_init(gen, d, up, dtype, device, lead),
        "w_gate_up": dense_init(gen, d, up, dtype, device, lead),
        "conv": conv1d_init(gen, up, 4, dtype, device, lead),
        "wq": dense_init(gen, up, up, dtype, device, lead),
        "wk": dense_init(gen, up, up, dtype, device, lead),
        "wv": dense_init(gen, up, up, dtype, device, lead),
        "w_igate": dense_init(gen, up, H, torch.float32, device, lead),    # gates in f32
        "w_fgate": dense_init(gen, up, H, torch.float32, device, lead),
        "out_norm": rmsnorm_init(up, dtype, device, lead),
        "w_down": dense_init(gen, up, d, dtype, device, lead),
    }


def _out_norm(h, p: Params, cfg, parallel=None) -> torch.Tensor:
    """``rmsnorm`` over the block's whole width; with ``parallel``, ``h``
    and the scale are this rank's channels, and the mean of squares is the
    ranks' means summed over ``model`` (differentiable) over m: at one rank
    the plain mean itself."""
    if parallel is None:
        return rmsnorm(h, p, cfg.norm_eps)
    x32 = h.float()
    var = parallel.all_sum(x32.square().mean(dim=-1, keepdim=True)) / parallel.size
    out = x32 * torch.rsqrt(var + cfg.norm_eps)
    return (out * p["scale"].float()).to(h.dtype)


def _whole(xu, xc, parallel):
    """``xu`` and the conv output ``xc`` over the block's whole width: with
    ``parallel`` each rank holds its channels of both, gathered over
    ``model`` in one packed all-gather (a reduce-scatter of their gradient
    backward)."""
    if parallel is None:
        return xu, xc
    return parallel.gather_blocks(torch.stack([xu, xc]), -1).unbind(0)


def _mlstm_qkvif(x, p, cfg, parallel=None):
    """xu and z (this rank's channels, partitioned), and q, k, v (B, T,
    H', dh) and the f32 gate pre-activations (B, T, H') of the heads whose
    columns ``p`` holds: all H, or partitioned H/m."""
    B, T, _ = x.shape
    if parallel is not None:
        x = parallel.enter(x)
    xu = matmul(x, p["w_up"])
    z = F.silu(matmul(x, p["w_gate_up"]))
    xc = F.silu(causal_conv1d(xu, p["conv"]))
    xu_all, xc_all = _whole(xu, xc, parallel)
    dh = 2 * cfg.d_model // cfg.n_heads
    q = matmul(xc_all, p["wq"]).reshape(B, T, -1, dh)
    kk = matmul(xc_all, p["wk"]).reshape(B, T, -1, dh) / math.sqrt(dh)
    v = matmul(xu_all, p["wv"]).reshape(B, T, -1, dh)
    i_pre = matmul(xc_all, p["w_igate"]).float()                   # (B,T,H')
    f_pre = matmul(xc_all, p["w_fgate"]).float()
    return xu, z, q, kk, v, i_pre, f_pre


def mlstm_parallel(q, k, v, i_pre, f_pre):
    """Stabilized quadratic parallel form. q, k, v: (B,T,H,dh)."""
    T = q.shape[1]
    F_ = torch.cumsum(F.logsigmoid(f_pre), dim=1)                  # sum_{r<=t} log f_r
    # log weight of source s at target t: F_t - F_s + i_s   (s <= t)
    logw = F_[:, :, None, :] - F_[:, None, :, :] + i_pre[:, None, :, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    logw = logw.masked_fill(~mask[None, :, :, None], float("-inf"))
    m = torch.clamp(logw.amax(dim=2, keepdim=True), min=NEG)        # stabilizer per t
    w = torch.exp(logw - m)                                        # (B,T,S,H)
    qk = torch.einsum("bthd,bshd->btsh", q.float(), k.float())
    a = w * qk
    num = torch.einsum("btsh,bshd->bthd", a, v.float())
    den = torch.maximum(a.sum(dim=2).abs(), torch.exp(-m[:, :, 0, :]))   # max(|n|, e^-m)
    return (num / den[..., None]).to(q.dtype)


def mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk: int = 256):
    """Chunkwise-parallel stabilized mLSTM: O(T c + T dh^2 / c) instead of
    O(T^2); the same function as :func:`mlstm_parallel`."""
    B, T, H, dh = q.shape
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the chunk {chunk}")
    dev = q.device
    log_f = F.logsigmoid(f_pre)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
    m_prev = torch.full((B, H), NEG, dtype=torch.float32, device=dev)
    hs = []
    for lo in range(0, T, chunk):
        qi, ki, vi = (x[:, lo:lo + chunk].float() for x in (q, k, v))   # (B,c,H,dh)
        ii = i_pre[:, lo:lo + chunk]
        Fc = torch.cumsum(log_f[:, lo:lo + chunk], dim=1)               # (B,c,H) inclusive
        # intra-chunk log-weights: F_t - F_s + i_s for s <= t
        logw = Fc[:, :, None, :] - Fc[:, None, :, :] + ii[:, None, :, :]
        logw = logw.masked_fill(~tri[None, :, :, None], float("-inf"))
        state_logw = Fc + m_prev[:, None, :]                            # (B,c,H)
        m_t = torch.clamp(torch.maximum(logw.amax(dim=2), state_logw), min=NEG)
        w = torch.exp(logw - m_t[:, :, None, :])                        # (B,c,s,H)
        sw = torch.exp(state_logw - m_t)                                # (B,c,H)
        a = w * torch.einsum("bthd,bshd->btsh", qi, ki)
        num = torch.einsum("btsh,bshd->bthd", a, vi)
        num = num + sw[..., None] * torch.einsum("bhvk,bthk->bthv", C, qi)
        den_in = a.sum(dim=2) + sw * torch.einsum("bhk,bthk->bth", n, qi)
        den = torch.maximum(den_in.abs(), torch.exp(-m_t))
        hs.append(num / den[..., None])                                 # (B,c,H,dh)
        # end-of-chunk state update, scaled by the new m
        F_last = Fc[:, -1, :]                                           # (B,H)
        src_logw = F_last[:, None, :] - Fc + ii                         # (B,c,H)
        m_new = torch.maximum(m_prev + F_last, src_logw.amax(dim=1))
        src_w = torch.exp(src_logw - m_new[:, None, :])
        decay = torch.exp(m_prev + F_last - m_new)                      # (B,H)
        C = decay[..., None, None] * C + torch.einsum("bshd,bshe,bsh->bhde", vi, ki, src_w)
        n = decay[..., None] * n + torch.einsum("bshd,bsh->bhd", ki, src_w)
        m_prev = m_new
    return torch.cat(hs, dim=1).to(q.dtype)


def _mlstm_out(h, z, p, cfg, parallel=None):
    """The normed h gated by z, times w_down; partitioned, this rank's
    channels of both, and w_down's row products summed over the ranks."""
    B, T = h.shape[:2]
    h = _out_norm(h.reshape(B, T, -1), p["out_norm"], cfg, parallel)
    out = matmul(h * z, p["w_down"])
    return out if parallel is None else parallel.leave(out)


def mlstm_block_forward(x, p, cfg):
    mp = model_parallel("mlstm")
    _, z, q, k, v, i_pre, f_pre = _mlstm_qkvif(x, p, cfg, mp)
    T = x.shape[1]
    if T >= 512 and T % 256 == 0:
        h = mlstm_chunkwise(q, k, v, i_pre, f_pre)
    else:
        h = mlstm_parallel(q, k, v, i_pre, f_pre)
    return _mlstm_out(h, z, p, cfg, mp)


def mlstm_block_prefill(x, p, cfg):
    """Forward, and the recurrent state that decode continues from
    (partitioned: this rank's heads of C, n and m, its channels of the
    conv inputs)."""
    mp = model_parallel("mlstm")
    xu, z, q, k, v, i_pre, f_pre = _mlstm_qkvif(x, p, cfg, mp)
    T = x.shape[1]
    chunk = 256 if (T % 256 == 0 and T >= 256) else T
    h = mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk)
    # the final state from the whole sequence's gates at once
    Fs = torch.cumsum(F.logsigmoid(f_pre), dim=1)                      # (B,T,H)
    src_logw = Fs[:, -1:, :] - Fs + i_pre
    m_new = src_logw.amax(dim=1)                                       # (B,H)
    src_w = torch.exp(src_logw - m_new[:, None, :])
    kf, vf = k.float(), v.float()
    C = torch.einsum("bshd,bshe,bsh->bhde", vf, kf, src_w)
    n = torch.einsum("bshd,bsh->bhd", kf, src_w)
    conv_state = F.pad(xu[:, -3:, :], (0, 0, max(3 - T, 0), 0))       # the last 3 rows
    return _mlstm_out(h, z, p, cfg, mp), {"C": C, "n": n, "m": m_new, "conv": conv_state}


def mlstm_state_init(batch: int, cfg, dtype=torch.float32, device=None,
                     lead: tuple = (), heads: int = 0) -> Dict[str, torch.Tensor]:
    """The zeroed state of ``heads`` heads (0: all; partitioned, a rank's
    H/m, the conv inputs their channels)."""
    H = heads or cfg.n_heads
    dh = 2 * cfg.d_model // cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros(lead + (batch, H, dh, dh), **f32),
        "n": torch.zeros(lead + (batch, H, dh), **f32),
        "m": torch.full(lead + (batch, H), NEG, **f32),
        "conv": torch.zeros(lead + (batch, 3, H * dh), dtype=dtype, device=device),
    }


def mlstm_block_step(x, p, cfg, state):
    """x: (B, 1, d). The recurrent mLSTM update (decode); returns the
    output (B, 1, d) and the new state (partitioned: this rank's heads and
    channels of a state held so)."""
    mp = model_parallel("mlstm")
    B = x.shape[0]
    x_t = x[:, 0, :]
    if mp is not None:
        x_t = mp.enter(x_t)
    xu = matmul(x_t, p["w_up"])
    z = F.silu(matmul(x_t, p["w_gate_up"]))
    xc, conv_state = causal_conv1d_step(xu, state["conv"], p["conv"])
    xc = F.silu(xc)
    xu_all, xc_all = _whole(xu, xc, mp)
    dh = 2 * cfg.d_model // cfg.n_heads
    q = matmul(xc_all, p["wq"]).reshape(B, -1, dh).float()
    k = (matmul(xc_all, p["wk"]).reshape(B, -1, dh) / math.sqrt(dh)).float()
    v = matmul(xu_all, p["wv"]).reshape(B, -1, dh).float()
    i_pre = matmul(xc_all, p["w_igate"]).float()                       # (B,H')
    log_f = F.logsigmoid(matmul(xc_all, p["w_fgate"]).float())
    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + state["m"] - m_new)
    C = f_g[..., None, None] * state["C"] + i_g[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = f_g[..., None] * state["n"] + i_g[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", C, q)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, -1).to(x.dtype)
    h = _out_norm(h, p["out_norm"], cfg, mp)
    out = matmul(h * z, p["w_down"])
    if mp is not None:
        out = mp.leave(out)
    return out[:, None, :], {"C": C, "n": n, "m": m_new, "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_ff(cfg) -> int:
    """The width of the sLSTM block's GLU feed-forward (4/3 of d_model, to
    a multiple of 64)."""
    return int(round(cfg.d_model * 4 / 3 / 64)) * 64 or 64


def slstm_init(gen: torch.Generator, cfg, dtype=torch.float32, device=None,
               lead: tuple = ()) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H

    def rinit():        # block-diagonal recurrent weights: (H, dh, dh)
        r = torch.randn(lead + (H, dh, dh), generator=gen, dtype=torch.float32, device=device)
        return (r / math.sqrt(dh)).to(dtype)

    ff = slstm_ff(cfg)
    return {
        "w_in": dense_init(gen, d, 4 * d, dtype, device, lead),     # i, f, z, o pre-acts
        "r_i": rinit(),
        "r_f": rinit(),
        "r_z": rinit(),
        "r_o": rinit(),
        "out_norm": rmsnorm_init(d, dtype, device, lead),
        "w_ff_up": dense_init(gen, d, 2 * ff, dtype, device, lead),  # GLU FFN (4/3)
        "w_ff_down": dense_init(gen, ff, d, dtype, device, lead),
    }


def _recurrent(p) -> torch.Tensor:
    """The four recurrent matrices side by side in f32, (H, dh, 4 dh): one
    batched product a step gives each gate's (the same sums)."""
    return torch.cat([p[n].float() for n in ("r_i", "r_f", "r_z", "r_o")], dim=-1)


def _slstm_cell(carry, gx, r):
    """One step. carry: (c, n, m, h), each (B, H, dh) f32; gx: the input's
    gate pre-activations (B, 4, H, dh) f32; r: :func:`_recurrent`."""
    c, n, m, h = carry
    rec = torch.einsum("bhd,hde->bhe", h, r).unflatten(-1, (4, -1))   # (B,H,4,dh)
    i_pre = gx[:, 0] + rec[:, :, 0]
    f_pre = gx[:, 1] + rec[:, :, 1]
    z_pre = gx[:, 2] + rec[:, :, 2]
    o_pre = gx[:, 3] + rec[:, :, 3]
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_pre)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, m_new, h_new


def slstm_state_init(batch: int, cfg, device=None, lead: tuple = (),
                     heads: int = 0) -> Dict[str, torch.Tensor]:
    """f32 whatever the compute dtype, as in the reference; of ``heads``
    heads (0: all; partitioned, a rank's H/m)."""
    shape = lead + (batch, heads or cfg.n_heads, cfg.d_model // cfg.n_heads)
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)   # noqa: E731
    return {"c": z(), "n": z(), "m": torch.full(shape, NEG, dtype=torch.float32, device=device),
            "h": z()}


def _slstm_gates(x, p, cfg, parallel=None) -> torch.Tensor:
    """The input's gate pre-activations (..., 4, H', dh) f32 of ``x`` (...,
    d): every head's, or with ``parallel`` this rank's H/m heads', whose
    four column blocks of the replicated w_in (gate-major: i, f, z, o, each
    H x dh) it reads as a strided view."""
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    w = p["w_in"]
    if parallel is not None:
        x = parallel.enter(x)
        n = H // parallel.size
        w = w.unflatten(-1, (4, H, dh))[..., parallel.index * n:(parallel.index + 1) * n, :]
        w = w.flatten(-3)
    return matmul(x, w).float().unflatten(-1, (4, -1, dh))


def _slstm_ffn(h, p, cfg, dtype, parallel=None):
    """The normed h through the GLU feed-forward; partitioned, ``h`` is this
    rank's channels, w_ff_up its rows (their products summed over the
    ranks) and w_ff_down whole."""
    h = _out_norm(h.to(dtype), p["out_norm"], cfg, parallel)
    up = matmul(h, p["w_ff_up"])
    if parallel is not None:
        up = parallel.leave(up)
    a, b = up.chunk(2, dim=-1)
    return matmul(F.gelu(a, approximate="tanh") * b, p["w_ff_down"])


def slstm_block_prefill(x, p, cfg):
    """x: (B, T, d). A loop over time (strictly sequential); returns the
    output and the last carry as the decode state (partitioned: this
    rank's heads)."""
    mp = model_parallel("slstm")
    B, T, _ = x.shape
    gates = _slstm_gates(x, p, cfg, mp)                                # (B,T,4,H',dh)
    r = _recurrent(p)
    st = slstm_state_init(B, cfg, x.device, heads=gates.shape[-2])
    carry = (st["c"], st["n"], st["m"], st["h"])
    hs = []
    for t in range(T):
        carry = _slstm_cell(carry, gates[:, t], r)
        hs.append(carry[3])
    h = torch.stack(hs, dim=1).reshape(B, T, -1)
    c, n, m, hh = carry
    return _slstm_ffn(h, p, cfg, x.dtype, mp), {"c": c, "n": n, "m": m, "h": hh}


def slstm_block_forward(x, p, cfg):
    return slstm_block_prefill(x, p, cfg)[0]


def slstm_block_step(x, p, cfg, state):
    mp = model_parallel("slstm")
    B = x.shape[0]
    gx = _slstm_gates(x[:, 0, :], p, cfg, mp)                          # (B,4,H',dh)
    c, n, m, hh = _slstm_cell((state["c"], state["n"], state["m"], state["h"]), gx,
                              _recurrent(p))
    out = _slstm_ffn(hh.reshape(B, -1), p, cfg, x.dtype, mp)
    return out[:, None, :], {"c": c, "n": n, "m": m, "h": hh}
