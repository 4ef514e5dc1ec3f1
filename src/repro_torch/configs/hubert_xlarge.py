"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 (cluster codebook) — encoder-only; conv waveform frontend is a
STUB per the assignment (input_specs supplies precomputed frame
embeddings); conv positional embedding + masked-prediction loss are
real. [arXiv:2106.07447; unverified]
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    is_encoder=True,
    positional="conv",
    modality="audio",
    source="arXiv:2106.07447",
))
