"""The reference's model zoo in PyTorch, for the decoder models whose
blocks the port has (the dense models, granite-moe-1b, recurrentgemma-2b):
GQA attention (windowless prefill through the K3 flash-attention kernel,
local windows through the plain chunked attention), SwiGLU MLP, the MoE
feed-forward, RG-LRU blocks, RMSNorm and RoPE, with dense KV caches and
recurrent states for live serving."""

from .convert import from_jax_params  # noqa: F401
from .transformer import TransformerLM, make_model  # noqa: F401
