"""The reference's model zoo in PyTorch, all ten of its models: GQA
attention (full-sequence attention through the K3 flash-attention
kernel, causal or an encoder's bidirectional, local blocks with their
window; decode through the plain chunked attention), MLA (the expanded prefill
through K3, the absorbed decode over the latent cache), SwiGLU MLP, the
MoE feed-forward, RG-LRU and xLSTM blocks, the vision projector and the
audio frontend, RMSNorm and RoPE, with dense KV caches, latent caches
and recurrent states for live serving."""

from .convert import from_jax_params  # noqa: F401
from .transformer import TransformerLM, make_model  # noqa: F401
