"""The benchmark's inputs of a model: its parameters, drawn from the seed
on the device in a few large calls, in the port's parameter tree (the one
``repro_torch.models.TransformerLM.init`` builds: the layers stacked
over tiles under ``blocks["g0"]``; weights ``(in, out)`` for ``x @ W``).
The plain reference reads the same tree by the same paths, so both sides
get the same numbers.

Matrices and the router are normal(0, 1/fan_in), the embedding
normal(0, 1/hidden_size), norm scales 1. One f32 draw a leaf, in the
order of :func:`leaf_specs`, from one generator: the same seed gives the
same values on the same device, and :func:`leaves` can draw them again
one at a time.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch


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


def leaves(c: dict, seed: int, device, dtype=torch.float32) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) in order, each drawn in f32 on ``device`` and cast to
    ``dtype`` (the router stays f32)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    for path, shape, std in leaf_specs(c):
        if std == 0.0:
            t = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(std)
        yield path, (t if keeps_f32(path) else t.to(dtype))


def flat(c: dict, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Every leaf by path."""
    return dict(leaves(c, seed, device, dtype))


def nest(flat_params: Dict[str, torch.Tensor]) -> dict:
    """The port's nested tree of a {path: leaf} map."""
    tree: dict = {}
    for path, t in flat_params.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def unnest(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The {path: leaf} map of a nested tree (the inverse of :func:`nest`)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        out.update(unnest(v, f"{prefix}/{k}" if prefix else k))
    return out
