"""RG-LRU recurrent block (recurrentgemma-2b, arXiv:2402.19427), in
PyTorch: the reference's ``repro.models.rglru``.

The Griffin/RecurrentGemma temporal-mixing block:

    x -> [linear x-branch, linear gate-branch]
    x-branch -> causal conv1d(4) -> input gate i_t, recurrence gate r_t
    a_t = exp(-c * softplus(Lambda) * sigmoid(r_t))        (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    out = o-gate(gate-branch) * h -> linear down

Prefill evaluates the diagonal linear recurrence over T with a log-depth
doubling scan in f32 (the reference's ``jax.lax.associative_scan``, the
same combine in another association); decode is the O(1) state update.
The reference computes both in XLA, so plain torch is the port.

The block may be partitioned over the ``model`` ranks on its width (the
``shardctx`` rule ``"model_parallel"`` with the family ``"rglru"``,
:func:`~repro_torch.models.layers.model_parallel`): wx, wgate,
w_input_gate and w_rec_gate then hold this rank's W/m columns, w_out its
rows, and log_lambda and the depthwise conv its channels. Every product
but the gates' reads a tensor the rank holds whole or its own channels of;
the gates are dense (W, W) products of the whole conv output, so each
rank gathers it (one all-gather a block; a reduce-scatter of its gradient
backward) and computes its gate columns. The recurrence and the state
(``h`` and ``conv``) are this rank's channels; w_out's partial products
are summed over the ranks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import (Params, causal_conv1d, causal_conv1d_step, conv1d_init, dense_init, matmul,
                     model_parallel)

_C = 8.0  # RG-LRU temperature constant (paper value)


def rglru_init(gen: torch.Generator, cfg, dtype=torch.float32, device=None,
               lead: tuple = ()) -> Params:
    W = cfg.lru_width
    # Lambda so that a^c is uniform in [0.9, 0.999] (the paper's init range)
    u = 0.9 + 0.099 * torch.rand(lead + (W,), generator=gen, dtype=torch.float32, device=device)
    log_lambda = torch.log(torch.expm1(-torch.log(u) / _C))             # softplus^-1
    return {
        "wx": dense_init(gen, cfg.d_model, W, dtype, device, lead),
        "wgate": dense_init(gen, cfg.d_model, W, dtype, device, lead),
        "conv": conv1d_init(gen, W, cfg.conv1d_size, dtype, device, lead),
        "w_input_gate": dense_init(gen, W, W, dtype, device, lead),
        "w_rec_gate": dense_init(gen, W, W, dtype, device, lead),
        "log_lambda": log_lambda,
        "w_out": dense_init(gen, W, cfg.d_model, dtype, device, lead),
    }


def _gates(xc: torch.Tensor, p: Params,
           parallel=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """log a_t (f32), the input gate i_t, and the sqrt(1 - a^2) multiplier;
    with ``parallel``, ``xc`` is this rank's channels of the conv output
    and the gate products read all of it (gathered over the ranks). The
    gate products read a node of their own either way, so that xc's
    gradient adds their sum to the input gate's part, as the gather's
    backward does: at one rank the two routes are one program, bit for
    bit."""
    src = xc.view_as(xc) if parallel is None else parallel.gather_blocks(xc, -1)
    r = torch.sigmoid(matmul(src, p["w_rec_gate"]).float())
    i = torch.sigmoid(matmul(src, p["w_input_gate"]))
    log_a = -_C * F.softplus(p["log_lambda"].float()) * r
    a2 = torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12))
    return log_a, i, beta


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h_{-1} = 0, for every t:
    the inclusive scan of the combine (a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)
    by recursive doubling (ceil(log2 T) steps)."""
    T = a.shape[1]
    d = 1
    while d < T:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(xc: torch.Tensor, p: Params, h0: Optional[torch.Tensor] = None,
               parallel=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence recurrence. xc: (B, T, W) post-conv (with
    ``parallel``, this rank's channels). Returns (h in xc's dtype, the f32
    last state h_T)."""
    log_a, i, beta = _gates(xc, p, parallel)
    gated = beta * (i * xc).float()
    a = torch.exp(log_a)
    if h0 is not None:                      # fold the carried state into step 0
        gated = torch.cat([gated[:, :1] + a[:, :1] * h0[:, None], gated[:, 1:]], dim=1)
    h = linear_scan(a, gated)
    return h.to(xc.dtype), h[:, -1]


def rglru_step(x_t: torch.Tensor, p: Params, h: torch.Tensor,
               parallel=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. x_t: (B, W) post-conv; h: (B, W) f32 state (with
    ``parallel``, this rank's channels of both)."""
    log_a, i, beta = _gates(x_t, p, parallel)
    h_new = torch.exp(log_a) * h + beta * (i * x_t).float()
    return h_new.to(x_t.dtype), h_new


def _branches(x: torch.Tensor, p: Params, parallel=None) -> Tuple[torch.Tensor, torch.Tensor]:
    if parallel is not None:
        x = parallel.enter(x)
    return matmul(x, p["wx"]), F.gelu(matmul(x, p["wgate"]), approximate="tanh")


def _out(y: torch.Tensor, p: Params, parallel) -> torch.Tensor:
    """``y @ w_out``; partitioned, the sum of the ranks' rows of it."""
    out = matmul(y, p["w_out"])
    return out if parallel is None else parallel.leave(out)


def rglru_block_forward(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    """Full sequence (no state in, no state out)."""
    mp = model_parallel("rglru")
    xb, gate = _branches(x, p, mp)
    h, _ = rglru_scan(causal_conv1d(xb, p["conv"]), p, parallel=mp)
    return _out(gate * h, p, mp)


def rglru_block_prefill(x: torch.Tensor, p: Params,
                        cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full sequence, and the state after it: ``h`` (B, W) f32 and ``conv``
    (B, K-1, W), the last K-1 conv inputs, left-padded with zeros when
    T < K-1 (partitioned: this rank's channels of both)."""
    mp = model_parallel("rglru")
    xb, gate = _branches(x, p, mp)
    h, h_last = rglru_scan(causal_conv1d(xb, p["conv"]), p, parallel=mp)
    K = cfg.conv1d_size
    conv_state = xb[:, -(K - 1):, :]
    pad = K - 1 - conv_state.shape[1]
    if pad > 0:
        conv_state = F.pad(conv_state, (0, 0, pad, 0))
    return _out(gate * h, p, mp), {"h": h_last, "conv": conv_state}


def rglru_block_step(x: torch.Tensor, p: Params, cfg,
                     state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. x: (B, 1, d_model). Returns the output (B, 1,
    d_model) and the new state (new tensors: the caller writes them back;
    partitioned, this rank's channels of a state held so)."""
    mp = model_parallel("rglru")
    xb, gate = _branches(x[:, 0, :], p, mp)
    xc, conv_state = causal_conv1d_step(xb, state["conv"], p["conv"])
    h_out, h_new = rglru_step(xc, p, state["h"], mp)
    return _out(gate * h_out, p, mp)[:, None, :], {"h": h_new, "conv": conv_state}
