"""GQA decoders in one stack of layers: RMSNorm, grouped-query attention
with an optional per-head RMSNorm of q and k, RoPE, and either a dense
SwiGLU MLP or a capacity MoE of SwiGLU experts (qwen3-1.7b and
granite-moe-1b-a400m). The port's tree is ``TransformerLM.init``'s: the
layers stacked under ``blocks["g0"]``, weights ``(in, out)`` for ``x @ W``.

Matrices and the router are normal(0, 1/fan_in), the embedding
normal(0, 1/hidden_size), norm scales 1. No leaf is sharded: every rank
draws the whole tree, and a cell's ranks do the same work.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Tuple

import torch

from chipbench.harness import weights, yardstick
from chipbench.reference import model as reference  # noqa: F401  (the interface's reference)

SPLIT_WORK = False

# file key -> ArchConfig field
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
          "head_dim": "head_dim", "intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
          "tie_word_embeddings": "tie_embeddings", "qk_norm": "qk_norm",
          "num_local_experts": "n_experts", "num_experts_per_tok": "top_k"}


def leaf_specs(c: dict) -> List[Tuple[str, tuple, float]]:
    """(path, shape, std) of every leaf of configuration ``c``; std 0 is a
    norm scale (ones). Paths are "/"-joined keys of the port's tree."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    H, KV, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    f, V, E = c["intermediate_size"], c["vocab_size"], c.get("num_local_experts", 0)
    g = "blocks/g0"
    out = [("embed", (V, d), 1.0 / math.sqrt(d)),
           (f"{g}/ln1/scale", (L, d), 0.0),
           (f"{g}/attn/wq", (L, d, H * hd), 1.0 / math.sqrt(d)),
           (f"{g}/attn/wk", (L, d, KV * hd), 1.0 / math.sqrt(d)),
           (f"{g}/attn/wv", (L, d, KV * hd), 1.0 / math.sqrt(d)),
           (f"{g}/attn/wo", (L, H * hd, d), 1.0 / math.sqrt(H * hd))]
    if c.get("qk_norm"):
        out += [(f"{g}/attn/q_norm/scale", (L, hd), 0.0),
                (f"{g}/attn/k_norm/scale", (L, hd), 0.0)]
    out.append((f"{g}/ln2/scale", (L, d), 0.0))
    if E:
        out += [(f"{g}/ffn/router", (L, d, E), 1.0 / math.sqrt(d)),
                (f"{g}/ffn/w_gate", (L, E, d, f), 1.0 / math.sqrt(d)),
                (f"{g}/ffn/w_up", (L, E, d, f), 1.0 / math.sqrt(d)),
                (f"{g}/ffn/w_down", (L, E, f, d), 1.0 / math.sqrt(f))]
    else:
        out += [(f"{g}/ffn/w_gate", (L, d, f), 1.0 / math.sqrt(d)),
                (f"{g}/ffn/w_up", (L, d, f), 1.0 / math.sqrt(d)),
                (f"{g}/ffn/w_down", (L, f, d), 1.0 / math.sqrt(f))]
    out.append(("final_norm/scale", (d,), 0.0))
    if not c.get("tie_word_embeddings"):
        out.append(("lm_head", (d, V), 1.0 / math.sqrt(d)))
    return out


def keeps_f32(path: str) -> bool:
    """Leaves the port keeps in f32 whatever its parameter dtype: the router."""
    return path.endswith("/router")


def leaves(c: dict, seed: int, device, dtype=torch.float32, rank: int = 0, world: int = 1
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every leaf, whole on every rank (:func:`weights.draw`)."""
    return weights.draw(leaf_specs(c), keeps_f32, seed, device, dtype)


def arch_config(c: dict):
    """The port's registry entry (``port``) with every width, depth and
    setting the file states put in, so the program runs what it says."""
    from repro_torch.configs import get_config

    kw = {f: c[k] for k, f in FIELDS.items() if k in c}
    if c.get("num_local_experts"):
        a = c["assumed"]
        kw.update(moe_d_ff=c["intermediate_size"], capacity_factor=a["capacity_factor"],
                  moe_renormalize=a["norm_topk_prob"])
    return dataclasses.replace(get_config(c["port"]), **kw)


def make_model(c: dict, ranks, **kw):
    """The port's model of ``c`` (``kw``: ``make_model``'s dtypes and
    remat), the same on every rank."""
    from repro_torch.models import make_model as port_model

    return port_model(arch_config(c), **kw)


def make_train_step(model, config, ranks):
    """The port's train step of ``model`` under ``config`` (a
    ``TrainConfig``), the same on every rank."""
    from repro_torch.training import make_train_step as port_step

    return port_step(model, config)


def param_counts(c: dict) -> tuple:
    """(total, active) parameters of a configuration file ``c`` (the
    published keys): the tied embedding counted once (it is the head), an
    MoE layer's routed experts at top-k of E for the active count."""
    d, L, V = c["hidden_size"], c["num_hidden_layers"], c["vocab_size"]
    H, KV, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    f = c["intermediate_size"]
    attn = d * H * hd * 2 + d * KV * hd * 2
    norms = 2 * d + (2 * hd if c.get("qk_norm") else 0)
    E = c.get("num_local_experts", 0)
    if E:
        k = c["num_experts_per_tok"]
        experts = E * 3 * d * f
        layer_total = attn + norms + d * E + experts
        layer_active = attn + norms + d * E + experts * k // E
    else:
        layer_total = layer_active = attn + norms + 3 * d * f
    head = V * d * (1 if c.get("tie_word_embeddings") else 2)
    return L * layer_total + head + d, L * layer_active + head + d


def train_step_flops(c: dict, B: int, T: int) -> float:
    """Model FLOPs of one training step: 6 x active parameters x tokens,
    plus attention at 12 x D x H x L x attended pairs a sequence (remat's
    second forward not counted)."""
    _, active = param_counts(c)
    pairs = yardstick.attended_pairs(T, T, True)
    D, H, L = c["head_dim"], c["num_attention_heads"], c["num_hidden_layers"]
    return 6.0 * active * B * T + 12.0 * D * H * L * pairs * B


def prefill_flops(c: dict, T: int) -> float:
    """Model FLOPs of one prefill of T tokens: 2 x active parameters x
    tokens plus attention at 4 x D x H x L x attended pairs."""
    _, active = param_counts(c)
    pairs = yardstick.attended_pairs(T, T, True)
    D, H, L = c["head_dim"], c["num_attention_heads"], c["num_hidden_layers"]
    return 2.0 * active * T + 4.0 * D * H * L * pairs


def attention_work(c: dict, B: int, T: int, lse: bool = True) -> dict:
    """(bytes, flops) of one causal K3 launch (``lse``: writing its lse)
    and one K3-bwd call over B sequences of T tokens, at head_dim."""
    H, KV, D = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    return {"k3": yardstick.k3_work(B, T, H, KV, D, lse=lse),
            "k3bwd": yardstick.k3bwd_work(B, T, H, KV, D)}


def bytes_per_block(c: dict, block_tokens: int) -> int:
    """K and V of every layer for one block of tokens, bf16."""
    return (c["num_hidden_layers"] * 2 * c["num_key_value_heads"] * c["head_dim"] * 2
            * block_tokens)


def cache_rows(caches, lo: int, n: int) -> tuple:
    """(k, v) rows ``lo .. lo + n - 1`` of the first sequence, (layers, n,
    kv heads, head_dim) each, copied."""
    g = caches["blocks"]["g0"]
    return tuple(g[name][:, 0, lo:lo + n].clone() for name in ("k", "v"))
