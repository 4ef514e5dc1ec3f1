"""Architecture + shape configuration system.

Every assigned architecture is an :class:`ArchConfig`; the four assigned
input shapes are :class:`ShapeConfig`. ``runnable(cfg, shape)`` encodes
the assignment's skip rules (encoder-only archs have no decode; 500k
decode requires a sub-quadratic family). ``reduced()`` produces the
structure-preserving small config used by the CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qk_norm: bool = False
    attention: str = "full"        # full | mla
    positional: str = "rope"       # rope | conv | none
    is_encoder: bool = False
    window: int = 0                # local-attention window
    block_pattern: Tuple[str, ...] = ("attn",)
    #   attn  = (global attn + FFN/MoE)   local = (windowed attn + FFN)
    #   rglru = (RG-LRU + FFN)            mlstm/slstm = self-contained
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_renormalize: bool = True
    capacity_factor: float = 1.25
    # deepseek-v2's MoE settings; each default is the plain top-k layer
    first_k_dense: int = 0         # leading layers with a dense SwiGLU of d_ff
    n_group: int = 1               # expert groups of the group-limited top-k
    topk_group: int = 1            # groups a token's experts are taken from
    routed_scaling: float = 1.0    # the routed experts' weights times this
    seq_aux: bool = False          # balance loss per sequence (f_i P_i), else Switch's
    aux_coef: float = 0.01         # the balance loss's weight in the loss
    expert_first: int = 0          # the first expert a layer holds
    experts_held: int = 0          # how many it holds (0: all n_experts)
    # MLA (deepseek-v2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    # recurrent (rglru)
    lru_width: int = 0
    conv1d_size: int = 4
    # modality stubs
    modality: str = "text"         # text | audio | vision_text
    vision_dim: int = 0
    n_image_tokens: int = 0
    # misc
    rope_theta: float = 10000.0
    # YaRN's rope_scaling (factor, original_max_position_embeddings, beta_fast,
    # beta_slow, mscale, mscale_all_dim); () is plain rope
    rope_yarn: Tuple[float, ...] = ()
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    source: str = ""               # provenance tag from the assignment

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.moe:
            E, g = self.n_experts, self.n_group
            if E % g or not 1 <= self.topk_group <= g or self.top_k > self.topk_group * E // g:
                raise ValueError(f"{self.name}: {self.top_k} of {E} experts cannot come from "
                                 f"{self.topk_group} of {g} groups")
            if not 0 <= self.expert_first < self.expert_first + self.held_experts <= E:
                raise ValueError(f"{self.name}: experts {self.expert_first} + "
                                 f"{self.held_experts} are not among its {E}")

    @property
    def held_experts(self) -> int:
        """The routed experts a layer holds (from ``expert_first``)."""
        return self.experts_held or self.n_experts

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (state/window-based)"""
        return self.family in ("hybrid", "ssm")

    @property
    def n_params(self) -> int:
        """Total parameter count (approximate, matches init)."""
        return sum(
            int(_np_prod(s)) for s in _param_shapes(self).values()
        )

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        total = 0
        for name, s in _param_shapes(self).items():
            n = int(_np_prod(s))
            if ".experts." in name:
                n = n * self.top_k // max(self.n_experts, 1)
            total += n
        return total

    def reduced(self) -> "ArchConfig":
        """Structure-preserving small config for CPU smoke tests."""
        pat = self.block_pattern
        n_layers = max(2 * len(pat), len(pat))  # >= 2 tiles when possible
        if self.n_layers < n_layers:
            n_layers = self.n_layers
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads)) if self.n_kv_heads else heads
        if self.n_kv_heads == self.n_heads:
            kv = heads
        kw = dict(
            n_layers=n_layers,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            window=min(self.window, 32) if self.window else 0,
        )
        if self.moe:
            kw.update(n_experts=8, top_k=min(self.top_k, 2), moe_d_ff=32)
        if self.attention == "mla":
            kw.update(
                q_lora_rank=32, kv_lora_rank=16, qk_rope_head_dim=8,
                qk_nope_head_dim=16, v_head_dim=16, head_dim=24,
            )
        if self.lru_width:
            kw.update(lru_width=64)
        if self.vision_dim:
            kw.update(vision_dim=32, n_image_tokens=8)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def runnable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment skip rules. Returns (runnable, reason-if-not)."""
    if shape.kind == "decode" and cfg.is_encoder:
        return False, "encoder-only arch: no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k context skipped per assignment"
    return True, ""


def _np_prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def _param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Closed-form parameter shape inventory (used for 6ND and memory
    estimates without materializing anything)."""
    d, hd = cfg.d_model, cfg.head_dim
    shapes: Dict[str, Tuple[int, ...]] = {}
    if cfg.modality == "audio":
        shapes["frontend.proj"] = (d, d)
        shapes["frontend.conv_pos"] = (128, d)
    else:
        shapes["embed"] = (cfg.vocab_size, d)
    if cfg.modality == "vision_text":
        shapes["projector.w1"] = (cfg.vision_dim, d)
        shapes["projector.w2"] = (d, d)

    K, G = cfg.first_k_dense, len(cfg.block_pattern)
    for li in range(cfg.n_layers):
        kind = "attn" if li < K else cfg.block_pattern[(li - K) % G]
        pre = f"layer{li}.{kind}"
        if kind in ("attn", "local"):
            if cfg.attention == "mla" and kind == "attn":
                shapes[f"{pre}.wq_a"] = (d, cfg.q_lora_rank)
                shapes[f"{pre}.wq_b"] = (
                    cfg.q_lora_rank,
                    cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim),
                )
                shapes[f"{pre}.wkv_a"] = (d, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                shapes[f"{pre}.w_uk"] = (cfg.kv_lora_rank, cfg.n_heads * cfg.qk_nope_head_dim)
                shapes[f"{pre}.w_uv"] = (cfg.kv_lora_rank, cfg.n_heads * cfg.v_head_dim)
                shapes[f"{pre}.wo"] = (cfg.n_heads * cfg.v_head_dim, d)
            else:
                shapes[f"{pre}.wq"] = (d, cfg.n_heads * hd)
                shapes[f"{pre}.wk"] = (d, cfg.n_kv_heads * hd)
                shapes[f"{pre}.wv"] = (d, cfg.n_kv_heads * hd)
                shapes[f"{pre}.wo"] = (cfg.n_heads * hd, d)
            if cfg.moe and kind == "attn" and li >= K:
                shapes[f"{pre}.router"] = (d, cfg.n_experts)
                for w, a, b in (("gate", d, cfg.moe_d_ff), ("up", d, cfg.moe_d_ff),
                                ("down", cfg.moe_d_ff, d)):
                    shapes[f"{pre}.experts.{w}"] = (cfg.held_experts, a, b)
                if cfg.n_shared_experts:
                    f = cfg.moe_d_ff * cfg.n_shared_experts
                    shapes[f"{pre}.shared.gate"] = (d, f)
                    shapes[f"{pre}.shared.up"] = (d, f)
                    shapes[f"{pre}.shared.down"] = (f, d)
            else:
                shapes[f"{pre}.ffn.gate"] = (d, cfg.d_ff)
                shapes[f"{pre}.ffn.up"] = (d, cfg.d_ff)
                shapes[f"{pre}.ffn.down"] = (cfg.d_ff, d)
        elif kind == "rglru":
            W = cfg.lru_width
            shapes[f"{pre}.wx"] = (d, W)
            shapes[f"{pre}.wgate"] = (d, W)
            shapes[f"{pre}.gates"] = (2 * W, W)
            shapes[f"{pre}.w_out"] = (W, d)
            shapes[f"{pre}.ffn.gate"] = (d, cfg.d_ff)
            shapes[f"{pre}.ffn.up"] = (d, cfg.d_ff)
            shapes[f"{pre}.ffn.down"] = (cfg.d_ff, d)
        elif kind == "mlstm":
            up = 2 * d
            shapes[f"{pre}.w_up"] = (d, up)
            shapes[f"{pre}.w_gate_up"] = (d, up)
            shapes[f"{pre}.wqkv"] = (3 * up, up)
            shapes[f"{pre}.w_down"] = (up, d)
        elif kind == "slstm":
            shapes[f"{pre}.w_in"] = (d, 4 * d)
            shapes[f"{pre}.rec"] = (4 * d, d // cfg.n_heads)
            ff = int(round(d * 4 / 3 / 64)) * 64 or 64
            shapes[f"{pre}.ffn"] = (d, 3 * ff)
    if not cfg.tie_embeddings and cfg.modality != "audio":
        shapes["lm_head"] = (d, cfg.vocab_size)
    elif cfg.modality == "audio":
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


# Registry populated by the per-arch modules.
_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from importlib import import_module

    for mod in (
        "qwen3_1p7b", "deepseek_7b", "stablelm_1p6b", "yi_34b",
        "recurrentgemma_2b", "deepseek_v2_236b", "granite_moe_1b",
        "hubert_xlarge", "xlstm_125m", "llava_next_mistral_7b",
    ):
        import_module(f"repro_torch.configs.{mod}")
