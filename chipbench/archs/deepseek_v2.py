"""DeepSeek-V2 as one chip's share of its training deployment: multi-head
latent attention (MLA) in every layer, the first ``first_k_dense_replace``
layers a dense SwiGLU, the others an MoE of routed experts (the router
over the published ``published.n_routed_experts``, group-limited greedy,
this chip holding ``n_routed_experts`` of them from
``deployment.first_expert``) and shared experts. The port's tree is
``TransformerLM.init``'s: the dense layers stacked under ``dense``, the
MoE layers under ``blocks["g0"]``, weights ``(in, out)`` for ``x @ W``;
the head is untied.

Matrices and the router are normal(0, 1/fan_in), the embedding
normal(0, 1/hidden_size), norm scales 1. No leaf is sharded: a cell's
one rank draws the whole tree.

The work is counted at the true widths: a token meets every product of
its layers (MLA, the dense MLP, the router, the shared experts), k x
held / E of an expert's (the choices that land on this chip's experts),
and the head; the embedding is a lookup and not counted. Attention a
pair and head: 2 x (qk + v) operations forward (QK^T at nope + rope, PV
at v), three times that for forward and backward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Tuple

import torch

from chipbench.harness import weights, yardstick
from chipbench.reference import deepseek_v2 as reference  # the interface's reference

SPLIT_WORK = False

# the settings this module and the port run; another value is another model
RUNS = {"hidden_act": "silu", "scoring_func": "softmax", "topk_method": "group_limited_greedy",
        "attention_bias": False, "moe_layer_freq": 1, "tie_word_embeddings": False}
# YaRN's keys, in the order of ``ArchConfig.rope_yarn``; ``rope_scaling``
# null is plain rope, any other type is refused
YARN = ("factor", "original_max_position_embeddings", "beta_fast", "beta_slow", "mscale",
        "mscale_all_dim")


def _check(c: dict) -> None:
    off = {k: c.get(k) for k, v in RUNS.items() if c.get(k) != v}
    rs = c.get("rope_scaling")
    if rs is not None and (rs.get("type") != "yarn" or set(rs) != {"type", *YARN}):
        off["rope_scaling"] = rs
    if off:
        raise ValueError(f"{c['port']}: {off} is not what the port runs ({RUNS}, "
                         f"rope_scaling null or yarn)")


def _rope_yarn(c: dict) -> tuple:
    rs = c["rope_scaling"]
    return () if rs is None else tuple(float(rs[k]) for k in YARN)


def _widths(c: dict) -> tuple:
    return (c["hidden_size"], c["num_attention_heads"], c["q_lora_rank"], c["kv_lora_rank"],
            c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"])


def _mla_specs(pre: str, L: int, c: dict) -> list:
    d, H, Rq, R, dn, dr, dv = _widths(c)
    return [(f"{pre}/ln1/scale", (L, d), 0.0),
            (f"{pre}/attn/wq_a", (L, d, Rq), 1.0 / math.sqrt(d)),
            (f"{pre}/attn/q_a_norm/scale", (L, Rq), 0.0),
            (f"{pre}/attn/wq_b", (L, Rq, H * (dn + dr)), 1.0 / math.sqrt(Rq)),
            (f"{pre}/attn/wkv_a", (L, d, R + dr), 1.0 / math.sqrt(d)),
            (f"{pre}/attn/kv_a_norm/scale", (L, R), 0.0),
            (f"{pre}/attn/w_uk", (L, R, H * dn), 1.0 / math.sqrt(R)),
            (f"{pre}/attn/w_uv", (L, R, H * dv), 1.0 / math.sqrt(R)),
            (f"{pre}/attn/wo", (L, H * dv, d), 1.0 / math.sqrt(H * dv)),
            (f"{pre}/ln2/scale", (L, d), 0.0)]


def _mlp_specs(pre: str, lead: tuple, d: int, f: int) -> list:
    return [(f"{pre}/w_gate", lead + (d, f), 1.0 / math.sqrt(d)),
            (f"{pre}/w_up", lead + (d, f), 1.0 / math.sqrt(d)),
            (f"{pre}/w_down", lead + (f, d), 1.0 / math.sqrt(f))]


def leaf_specs(c: dict) -> List[Tuple[str, tuple, float]]:
    """(path, shape, std) of every leaf of configuration ``c``; std 0 is a
    norm scale (ones). Paths are "/"-joined keys of the port's tree."""
    d, V = c["hidden_size"], c["vocab_size"]
    K = c["first_k_dense_replace"]
    L = c["num_hidden_layers"] - K
    E, _, held = reference.experts(c)
    f = c["moe_intermediate_size"]
    out = [("embed", (V, d), 1.0 / math.sqrt(d))]
    if K:
        out += _mla_specs("dense", K, c) + _mlp_specs("dense/ffn", (K,), d,
                                                      c["intermediate_size"])
    g = "blocks/g0"
    out += _mla_specs(g, L, c)
    out.append((f"{g}/ffn/router", (L, d, E), 1.0 / math.sqrt(d)))
    out += _mlp_specs(f"{g}/ffn", (L, held), d, f)
    out += _mlp_specs(f"{g}/ffn/shared", (L,), d, f * c["n_shared_experts"])
    out += [("final_norm/scale", (d,), 0.0), ("lm_head", (d, V), 1.0 / math.sqrt(d))]
    return out


def keeps_f32(path: str) -> bool:
    """Leaves the port keeps in f32 whatever its parameter dtype: the router."""
    return path.endswith("/router")


def leaves(c: dict, seed: int, device, dtype=torch.float32, rank: int = 0, world: int = 1
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every leaf, whole (:func:`weights.draw`)."""
    return weights.draw(leaf_specs(c), keeps_f32, seed, device, dtype)


def arch_config(c: dict):
    """The port's registry entry (``port``) with every width, depth and
    setting the file states put in: the router over the published
    experts, this chip holding its share of them."""
    from repro_torch.configs import get_config

    _check(c)
    d, H, Rq, R, dn, dr, dv = _widths(c)
    E, first, held = reference.experts(c)
    a = c["assumed"]
    return dataclasses.replace(
        get_config(c["port"]), n_layers=c["num_hidden_layers"], d_model=d, n_heads=H,
        n_kv_heads=c["num_key_value_heads"], head_dim=dn + dr, q_lora_rank=Rq, kv_lora_rank=R,
        qk_nope_head_dim=dn, qk_rope_head_dim=dr, v_head_dim=dv, d_ff=c["intermediate_size"],
        moe_d_ff=c["moe_intermediate_size"], vocab_size=c["vocab_size"],
        rope_theta=float(c["rope_theta"]), rope_yarn=_rope_yarn(c), norm_eps=c["rms_norm_eps"],
        tie_embeddings=False,
        n_experts=E, top_k=c["num_experts_per_tok"], n_shared_experts=c["n_shared_experts"],
        first_k_dense=c["first_k_dense_replace"], n_group=c["n_group"],
        topk_group=c["topk_group"], routed_scaling=float(c["routed_scaling_factor"]),
        moe_renormalize=c["norm_topk_prob"], seq_aux=c["seq_aux"],
        aux_coef=a["aux_loss_alpha"], capacity_factor=a["capacity_factor"],
        expert_first=first, experts_held=held)


def make_model(c: dict, ranks, **kw):
    """The port's model of ``c`` (``kw``: ``make_model``'s dtypes and remat)."""
    from repro_torch.models import make_model as port_model

    return port_model(arch_config(c), **kw)


def make_train_step(model, config, ranks):
    """The port's train step of ``model`` under ``config`` (a ``TrainConfig``)."""
    from repro_torch.training import make_train_step as port_step

    return port_step(model, config)


def param_counts(c: dict) -> tuple:
    """(held, met) parameters of ``c``: every parameter this chip holds,
    and those a token meets (module docstring): the held routed experts
    at k x held / E of one, the embedding left out."""
    share = c["num_experts_per_tok"] / reference.experts(c)[0]     # of a held expert, a token
    held, met = 0, 0.0
    for path, shape, _ in leaf_specs(c):
        n = math.prod(shape)
        held += n
        routed = path.startswith("blocks/g0/ffn/w_") and len(shape) == 4
        met += 0 if path == "embed" else n * share if routed else n
    return held, met


def _attention_flops(c: dict, T: int) -> float:
    """Forward operations of every layer's attention over one sequence."""
    pairs = yardstick.attended_pairs(T, T, True)
    dqk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return (2.0 * (dqk + c["v_head_dim"]) * c["num_attention_heads"]
            * c["num_hidden_layers"] * pairs)


def train_step_flops(c: dict, B: int, T: int) -> float:
    """Model FLOPs of one training step: 6 x the parameters a token meets
    x tokens, plus 3 x attention's forward (remat's second forward not
    counted)."""
    return 6.0 * param_counts(c)[1] * B * T + 3.0 * _attention_flops(c, T) * B


def prefill_flops(c: dict, T: int) -> float:
    """Model FLOPs of one prefill of T tokens."""
    return 2.0 * param_counts(c)[1] * T + _attention_flops(c, T)


def attention_work(c: dict, B: int, T: int, lse: bool = True) -> dict:
    """(bytes, flops) of one causal K3 launch (``lse``: writing its lse) and
    one K3-bwd call over B sequences of T tokens, at MLA's true widths:
    q and k at nope + rope, v and the output at v (the op pads both to
    its kernel's width; the padding is not work). K3: q, k, v read and
    the output written once, QK^T and PV. K3-bwd: q, k, v, out, dout and
    the f32 lse read, dq, dk, dv written; S and dQ, dK at qk, dP and dV at
    v."""
    H, dqk = c["num_attention_heads"], c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    dv = c["v_head_dim"]
    pairs = yardstick.attended_pairs(T, T, True)
    rows = B * T * H
    k3 = (2 * rows * (2 * dqk + 2 * dv) + (4 * B * H * T if lse else 0),
          2.0 * B * H * pairs * (dqk + dv))
    k3bwd = (2 * rows * (4 * dqk + 4 * dv) + 4 * B * H * T,
             2.0 * B * H * pairs * (3 * dqk + 2 * dv))
    return {"k3": k3, "k3bwd": k3bwd}


def bytes_per_block(c: dict, block_tokens: int) -> int:
    """The cached latent of every layer for one block of tokens, bf16:
    kv_lora_rank + qk_rope_head_dim a token and layer."""
    return (c["num_hidden_layers"] * (c["kv_lora_rank"] + c["qk_rope_head_dim"]) * 2
            * block_tokens)


def cache_rows(caches, lo: int, n: int) -> tuple:
    """(c_kv, k_rope) rows ``lo .. lo + n - 1`` of the first sequence,
    (layers, n, kv_lora_rank) and (layers, n, rope), the dense layers
    first, copied."""
    groups = [caches[k] for k in ("dense",) if k in caches] + [caches["blocks"]["g0"]]
    return tuple(torch.cat([g[name][:, 0, lo:lo + n] for g in groups]).clone()
                 for name in ("c_kv", "k_rope"))
