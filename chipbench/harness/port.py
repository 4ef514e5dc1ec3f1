"""The port's configuration of a configuration file: its registry entry
(``port``) with every width, depth and setting the file states put in, so
the program runs what the file says."""

from __future__ import annotations

import dataclasses

# file key -> ArchConfig field
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
          "head_dim": "head_dim", "intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
          "tie_word_embeddings": "tie_embeddings", "qk_norm": "qk_norm",
          "num_local_experts": "n_experts", "num_experts_per_tok": "top_k"}


def arch_config(c: dict):
    from repro_torch.configs import get_config

    kw = {f: c[k] for k, f in FIELDS.items() if k in c}
    if c.get("num_local_experts"):
        a = c["assumed"]
        kw.update(moe_d_ff=c["intermediate_size"], capacity_factor=a["capacity_factor"],
                  moe_renormalize=a["norm_topk_prob"])
    return dataclasses.replace(get_config(c["port"]), **kw)
