"""llava-next-mistral-7b [vlm]: mistral-7b backbone (32L d_model=4096 32H
GQA kv=8 d_ff=14336 vocab=32000) + anyres image tiling. The vision tower
is a STUB per the assignment (input_specs supplies precomputed patch
embeddings, CLIP-L dim 1024); the 2-layer MLP projector is real.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    modality="vision_text",
    vision_dim=1024,
    n_image_tokens=1152,   # anyres: base 576 + one 576 tile (stub default)
    rope_theta=1_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))
