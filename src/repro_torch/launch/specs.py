"""``input_specs()``: stand-ins for every model input of every (arch x
shape) cell as tensors on the ``meta`` device: the keys, shapes and dtypes
of the real inputs, nothing allocated (the reference's
``repro.launch.specs`` returns ``jax.ShapeDtypeStruct``s). The launchers
make real tensors of the same structure.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import ArchConfig, ShapeConfig, get_config


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, T = shape.global_batch, shape.seq_len
    if cfg.modality == "audio":
        return {
            "frames": _sds((B, T, cfg.d_model), torch.bfloat16),
            "labels": _sds((B, T), torch.int32),
            "mask": _sds((B, T), torch.bool),
        }
    if cfg.modality == "vision_text":
        t_text = T - cfg.n_image_tokens
        return {
            "tokens": _sds((B, t_text), torch.int32),
            "labels": _sds((B, t_text), torch.int32),
            "mask": _sds((B, t_text), torch.bool),
            "image_embeds": _sds((B, cfg.n_image_tokens, cfg.vision_dim), torch.bfloat16),
        }
    return {
        "tokens": _sds((B, T), torch.int32),
        "labels": _sds((B, T), torch.int32),
        "mask": _sds((B, T), torch.bool),
    }


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    specs = train_batch_specs(cfg, shape)
    specs.pop("labels", None)
    if not cfg.is_encoder:
        specs.pop("mask", None)
    return specs


def decode_inputs_specs(cfg: ArchConfig, shape: ShapeConfig, model) -> Dict[str, Any]:
    """(tokens, caches, position) specs for one decode step; the caches'
    from the model's own cache shapes (``TransformerLM.cache_specs``, the
    tree ``init_cache`` allocates)."""
    B, S = shape.global_batch, shape.seq_len
    return {
        "tokens": _sds((B, 1), torch.int32),
        "caches": model.cache_specs(B, S),
        "position": _sds((B,), torch.int32),
    }


def input_specs(arch: str, shape_cfg: ShapeConfig, model=None) -> Dict[str, Any]:
    cfg = get_config(arch)
    if shape_cfg.kind == "train":
        return train_batch_specs(cfg, shape_cfg)
    if shape_cfg.kind == "prefill":
        return prefill_batch_specs(cfg, shape_cfg)
    if model is None:
        raise ValueError("decode specs need the model (cache shapes)")
    return decode_inputs_specs(cfg, shape_cfg, model)
