"""xlstm-125m [ssm]: 12L d_model=768 4H vocab=50304, d_ff=0 (FFN capacity
lives inside the blocks) — mLSTM + sLSTM mix; we tile (5x mLSTM, 1x
sLSTM) x 2 (the closest 12-layer realization of the paper's m:s-heavy
ratios; documented in DESIGN.md). [arXiv:2405.04517; unverified]
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    positional="none",
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    tie_embeddings=True,
    source="arXiv:2405.04517",
))
