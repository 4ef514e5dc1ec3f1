"""Carrying the reference's parameters across.

``from_jax_params(tree, cfg, device=...)`` takes the parameter tree of
``repro.models.TransformerLM.init`` as numpy arrays (``jax.tree.map(np.asarray,
params)``; the port does not import JAX) and returns the port's parameters:
the same tree of tensors on ``device``, in the same dtypes. With them both
packages compute the same logits, which is how the tests hold the port to
the reference: a ``torch.Generator`` cannot give ``jax.random``'s bits.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def param_shapes(cfg) -> Dict:
    """The tree of the dense model's parameter shapes, ``blocks`` stacked
    over its ``n_layers`` one-layer tiles."""
    L, d, hd, ff = cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.d_ff
    attn = {"wq": (L, d, cfg.n_heads * hd), "wk": (L, d, cfg.n_kv_heads * hd),
            "wv": (L, d, cfg.n_kv_heads * hd), "wo": (L, cfg.n_heads * hd, d)}
    if cfg.qk_norm:
        attn.update(q_norm={"scale": (L, hd)}, k_norm={"scale": (L, hd)})
    tree = {
        "embed": (cfg.vocab_size, d),
        "blocks": {"g0": {
            "ln1": {"scale": (L, d)}, "attn": attn, "ln2": {"scale": (L, d)},
            "ffn": {"w_gate": (L, d, ff), "w_up": (L, d, ff), "w_down": (L, ff, d)},
        }},
        "final_norm": {"scale": (d,)},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = (d, cfg.vocab_size)
    return tree


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                     # a writable copy, C-contiguous
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree, shapes, device, path: str):
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path or 'params'}: expected keys {sorted(shapes)}, got {got}")
        return {k: _convert(tree[k], shapes[k], device, f"{path}/{k}") for k in shapes}
    if tuple(np.shape(tree)) != tuple(shapes):
        raise ValueError(f"{path}: expected shape {tuple(shapes)}, got {tuple(np.shape(tree))}")
    return _tensor(tree, device)


def from_jax_params(tree, cfg, *, device: DeviceLike = None) -> Dict:
    """The reference's parameter tree (numpy leaves) as the port's, on
    ``device`` (None: the card). Raises on a missing or extra key or a
    shape that does not fit ``cfg``."""
    return _convert(tree, param_shapes(cfg), resolve_device(device), "")
