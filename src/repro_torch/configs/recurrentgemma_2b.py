"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, pattern (rec, rec, local-attn),
window 2048, head_dim 256, lru_width 2560. [arXiv:2402.19427; hf]
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    window=2048,
    block_pattern=("rglru", "rglru", "local"),
    lru_width=2560,
    conv1d_size=4,
    tie_embeddings=True,
    source="arXiv:2402.19427",
))
