"""The dense transformer of the reference's model zoo, in PyTorch: GQA
attention (prefill through the K3 flash-attention kernel), SwiGLU MLP,
RMSNorm and RoPE, with dense KV caches for live serving."""

from .convert import from_jax_params  # noqa: F401
from .transformer import TransformerLM, make_model  # noqa: F401
