"""Tuning knobs, read from environment variables at call time, with the
reference's names and defaults (``repro.launch.tuning``).

REPRO_KV_CHUNK            keys a step of the chunked online-softmax
                          attention (``models.attention.chunked_attention``)
REPRO_REMAT_POLICY        dots | none | full  (checkpoint policy inside tiles)
REPRO_SEQ_PARALLEL        1 | 0   (sequence-shard the residual stream carry)
REPRO_CAUSAL_FOLD         1 | 0   (folded causal attention)
REPRO_PURE_DP_THRESHOLD   parameter count below which dense models train
                          data-parallel only
REPRO_FLASH_DECODE        1 | 0   (sequence-sharded KV cache, merged decode)
REPRO_MICROBATCH          gradient-accumulation factor
REPRO_SCAN_UNROLL         1 | 0   (unroll the internal scans)

The port reads ``kv_chunk`` where the reference does, inside
``chunked_attention`` when no chunk is given. The other seven are read
nowhere, in the port as in the reference's models; they are kept so that
a launcher or a sweep finds the same names in both packages.
"""

from __future__ import annotations

import os


def kv_chunk(default: int = 1024) -> int:
    return int(os.environ.get("REPRO_KV_CHUNK", default))


def remat_policy(default: str = "full") -> str:
    """'full' saves nothing inside a tile and recomputes its forward in
    the backward; 'dots' also keeps the matmul outputs."""
    return os.environ.get("REPRO_REMAT_POLICY", default)


def seq_parallel(default: bool = True) -> bool:
    return os.environ.get("REPRO_SEQ_PARALLEL", "1" if default else "0") == "1"


def causal_fold(default: bool = False) -> bool:
    return os.environ.get("REPRO_CAUSAL_FOLD", "1" if default else "0") == "1"


def pure_dp_threshold(default: int = 500_000_000) -> int:
    """Dense models below this parameter count train data-parallel only:
    the ``model`` axis carries batch instead of tensor parallelism
    (REPRO_PURE_DP_THRESHOLD=0 disables it)."""
    return int(os.environ.get("REPRO_PURE_DP_THRESHOLD", default))


def flash_decode(default: bool = True) -> bool:
    """Sequence-sharded KV cache with the log-sum-exp merged decode
    (``launch.flash_decode``); REPRO_FLASH_DECODE=0 turns it off."""
    return os.environ.get("REPRO_FLASH_DECODE", "1" if default else "0") == "1"


def microbatches(default: int = 1) -> int:
    """Gradient-accumulation factor for training (REPRO_MICROBATCH)."""
    return int(os.environ.get("REPRO_MICROBATCH", default))


def scan_unroll(default: bool = False) -> bool:
    """Unroll every internal scan. In the reference it steers XLA's
    unrolling of its ``lax.scan`` loops only (for cost analysis); the
    port's loops are Python loops, so the port reads it nowhere."""
    return os.environ.get("REPRO_SCAN_UNROLL", "1" if default else "0") == "1"
