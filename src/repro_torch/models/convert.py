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

from .xlstm import slstm_ff


def _block_shapes(cfg, kind: str, lead: tuple) -> Dict:
    """One block's parameter shapes, with ``lead`` axes in front."""
    d, hd = cfg.d_model, cfg.head_dim
    s = lambda *shape: lead + shape
    mlp = lambda f: {"w_gate": s(d, f), "w_up": s(d, f), "w_down": s(f, d)}
    tree = {"ln1": {"scale": s(d)}}
    if kind == "mlstm":
        up, H = 2 * d, cfg.n_heads
        tree["core"] = {"w_up": s(d, up), "w_gate_up": s(d, up),
                        "conv": {"w": s(4, up), "b": s(up)},
                        "wq": s(up, up), "wk": s(up, up), "wv": s(up, up),
                        "w_igate": s(up, H), "w_fgate": s(up, H),
                        "out_norm": {"scale": s(up)}, "w_down": s(up, d)}
        return tree
    if kind == "slstm":
        H = cfg.n_heads
        ff, rec = slstm_ff(cfg), s(H, d // H, d // H)
        tree["core"] = {"w_in": s(d, 4 * d), "r_i": rec, "r_f": rec, "r_z": rec, "r_o": rec,
                        "out_norm": {"scale": s(d)}, "w_ff_up": s(d, 2 * ff),
                        "w_ff_down": s(ff, d)}
        return tree
    if kind == "rglru":
        W, K = cfg.lru_width, cfg.conv1d_size
        tree["core"] = {"wx": s(d, W), "wgate": s(d, W), "conv": {"w": s(K, W), "b": s(W)},
                        "w_input_gate": s(W, W), "w_rec_gate": s(W, W),
                        "log_lambda": s(W), "w_out": s(W, d)}
    elif cfg.attention == "mla" and kind == "attn":
        H, R, Dr = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
        tree["attn"] = {"wq_a": s(d, cfg.q_lora_rank), "q_a_norm": {"scale": s(cfg.q_lora_rank)},
                        "wq_b": s(cfg.q_lora_rank, H * (cfg.qk_nope_head_dim + Dr)),
                        "wkv_a": s(d, R + Dr), "kv_a_norm": {"scale": s(R)},
                        "w_uk": s(R, H * cfg.qk_nope_head_dim), "w_uv": s(R, H * cfg.v_head_dim),
                        "wo": s(H * cfg.v_head_dim, d)}
    else:
        attn = {"wq": s(d, cfg.n_heads * hd), "wk": s(d, cfg.n_kv_heads * hd),
                "wv": s(d, cfg.n_kv_heads * hd), "wo": s(cfg.n_heads * hd, d)}
        if cfg.qk_norm:
            attn.update(q_norm={"scale": s(hd)}, k_norm={"scale": s(hd)})
        tree["attn"] = attn
    tree["ln2"] = {"scale": s(d)}
    if cfg.moe and kind == "attn":
        E, f = cfg.n_experts, cfg.moe_d_ff
        tree["ffn"] = {"router": s(d, E), "w_gate": s(E, d, f), "w_up": s(E, d, f),
                       "w_down": s(E, f, d)}
        if cfg.n_shared_experts > 0:
            tree["ffn"]["shared"] = mlp(f * cfg.n_shared_experts)
    else:
        tree["ffn"] = mlp(cfg.d_ff)
    return tree


def param_shapes(cfg) -> Dict:
    """The tree of the model's parameter shapes: the frontend (``embed``,
    or an audio model's ``frontend_proj``, ``conv_pos`` and
    ``mask_embed``; a vision model's ``projector`` too); ``blocks`` holds
    one entry per kind of ``cfg.block_pattern``, stacked over
    ``n_layers // G`` tiles; ``tail`` lists the ``n_layers % G`` blocks
    left over."""
    G = len(cfg.block_pattern)
    n_tiles, n_tail = cfg.n_layers // G, cfg.n_layers % G
    d = cfg.d_model
    if cfg.modality == "audio":
        tree = {"frontend_proj": (d, d), "conv_pos": {"w": (128, d), "b": (d,)},
                "mask_embed": (d,)}
    else:
        tree = {"embed": (cfg.vocab_size, d)}
    if cfg.modality == "vision_text":
        tree["projector"] = {"w1": (cfg.vision_dim, d), "w2": (d, d)}
    if n_tiles:
        tree["blocks"] = {f"g{g}": _block_shapes(cfg, kind, (n_tiles,))
                          for g, kind in enumerate(cfg.block_pattern)}
    if n_tail:
        tree["tail"] = [_block_shapes(cfg, kind, ()) for kind in cfg.block_pattern[:n_tail]]
    tree["final_norm"] = {"scale": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return tree


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                     # a writable copy, C-contiguous
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree, shapes, device, path: str):
    if isinstance(shapes, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(shapes):
            got = len(tree) if isinstance(tree, (list, tuple)) else type(tree).__name__
            raise ValueError(f"{path}: expected a list of {len(shapes)} blocks, got {got}")
        return [_convert(t, sh, device, f"{path}/{i}") for i, (t, sh) in enumerate(zip(tree, shapes))]
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
    ``device`` (None: the card). Raises on a missing or extra key, a tail
    of another length or a shape that does not fit ``cfg``."""
    return _convert(tree, param_shapes(cfg), resolve_device(device), "")
