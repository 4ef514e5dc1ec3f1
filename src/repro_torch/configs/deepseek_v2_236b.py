"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MoE 160 routed experts top-6 + 2 shared — MLA attention
with kv_lora_rank=512, q_lora_rank=1536, decoupled RoPE (64) + nope (128)
and v_head_dim=128. [arXiv:2405.04434; hf]

Assignment simplification (documented in DESIGN.md): every layer is MoE
(real DSv2 uses a dense first layer).

This entry is the JAX reference's variant, which the parity tests hold
the port to, and not the published model: besides every layer being MoE,
routing is a plain top-6 with renormalised weights, no group limit
(``n_group`` 8, ``topk_group`` 3), no x16 routed scaling and a
batch-wide balance loss. The published layout and routing are this
entry with the ``ArchConfig`` fields ``first_k_dense``, ``n_group``,
``topk_group``, ``routed_scaling``, ``seq_aux`` and ``moe_renormalize``
set through ``dataclasses.replace`` (``chipbench/archs/deepseek_v2.py``).
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    attention="mla",
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    head_dim=192,
    source="arXiv:2405.04434",
))
