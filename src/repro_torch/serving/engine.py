"""Multi-tenant serving engine — the paper's caching system deployed in
front of an LLM.

Tenants (the paper's proxies) are admitted by the working-set admission
controller (Section IV-C), each receiving a *virtual* HBM budget over
the shared paged KV pool. Requests flow:

  1. admission-time ``lookup`` on the shared prefix cache (a chain of
     MCD gets): the usable cached prefix skips prefill compute;
  2. prefill of the remaining suffix (compute priced per token);
  3. write-back (``set`` per new block) — may ripple-evict other
     tenants' blocks exactly per Section III;
  4. decode (live mode only): the model prefills the whole prompt into
     dense per-request KV caches, its causal attention (local blocks'
     within their window) running K3
     (:func:`repro_torch.kernels.ops.flash_attention`), and
     :func:`~repro_torch.serving.sampler.greedy_decode` decodes
     ``max_new_tokens`` tokens on them.

The engine runs in two modes, both over a :class:`BlockPool` on
``device`` (the CUDA card unless the caller names another):
* accounting mode (``model=None``): the full cache behaviour with a
  FLOPs/latency cost model. Nothing decodes; a caller that decodes from
  the shared pool reads it itself, composing ``cache.block_table``,
  ``pool.layer_pool`` and the kernels of :mod:`repro_torch.kernels.ops`
  (``chip_smoke.py`` does so);
* live mode (``model=``, ``params=`` of :mod:`repro_torch.models`, the
  parameters on ``device``): each request is also prefilled and decoded,
  and its result carries the generated tokens. As in the reference, the
  whole prompt is prefilled even when a prefix of it hit the cache: the
  hit is accounted (``cached_tokens``, ``flops_saved``), not skipped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.cacheblocks import BlockPool, SharedPrefixCache, layout_for
from repro_torch.core.admission import AdmissionController
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tracing import request

from .sampler import greedy_decode


@dataclass
class TenantSpec:
    name: str
    b_star_bytes: float            # SLA allocation (unshared-equivalent)


@dataclass
class Request:
    tenant: str
    tokens: np.ndarray             # prompt token ids
    max_new_tokens: int = 16
    req_id: int = 0


@dataclass
class RequestResult:
    req_id: int
    tenant: str
    cached_tokens: int
    prefill_tokens: int
    new_tokens: int
    flops_saved: float
    evictions: int
    ripple_evictions: int
    output: Optional[np.ndarray] = None


@dataclass
class EngineConfig:
    block_tokens: int = 16
    pool_blocks: int = 4096
    ghost_retention: bool = True
    rre_slack: float = 0.0         # >0: b_hat = b * (1 + slack)


class ServingEngine:
    def __init__(
        self,
        arch_cfg,
        tenants: Sequence[TenantSpec],
        engine_cfg: EngineConfig = EngineConfig(),
        *,
        model=None,
        params=None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = arch_cfg
        self.engine_cfg = engine_cfg
        self.layout = layout_for(arch_cfg, block_tokens=engine_cfg.block_tokens)
        bpb = max(self.layout.bytes_per_block, self.layout.state_bytes, 1)
        pool_bytes = engine_cfg.pool_blocks * bpb
        self.pool = BlockPool(
            engine_cfg.pool_blocks,
            engine_cfg.block_tokens,
            arch_cfg.n_kv_heads,
            arch_cfg.head_dim,
            1,  # accounting pool tracks layer-0 pages; bytes scale by L
            device=self.device,
        )
        # Admission control (Section IV-C): conservative eq. (13) +
        # working-set refresh once popularities are observed.
        self.admission = AdmissionController(
            physical_capacity=float(pool_bytes),
            lengths=np.full(1024, float(bpb)),  # refreshed with real stats
            device=self.device,
        )
        self.tenants: Dict[str, TenantSpec] = {}
        admitted = {}
        for t in tenants:
            d = self.admission.admit(t.name, t.b_star_bytes)
            if d.admitted:
                self.tenants[t.name] = t
                admitted[t.name] = int(
                    self.admission.tenants[t.name].b_virtual
                )
        if not admitted:
            raise ValueError("no tenant admitted — pool too small")
        ripple = None
        if engine_cfg.rre_slack > 0:
            ripple = {
                n: int(b * (1.0 + engine_cfg.rre_slack))
                for n, b in admitted.items()
            }
        self.cache = SharedPrefixCache(
            self.pool,
            self.layout,
            admitted,
            physical_capacity_bytes=pool_bytes,
            ghost_retention=engine_cfg.ghost_retention,
            ripple_allocations=ripple,
        )
        self.model = model
        self.params = params
        self._next_id = 0
        self.results: List[RequestResult] = []

    # ------------------------------------------------------------------
    def flops_per_token_prefill(self) -> float:
        return 2.0 * self.cfg.n_active_params

    def submit(self, tenant: str, tokens, max_new_tokens: int = 16) -> RequestResult:
        """Process one request: prefix lookup, write-back of its blocks and,
        in live mode, prefill + greedy decode of ``max_new_tokens`` tokens
        (``output``: (1, max_new_tokens) int32). In accounting mode
        ``new_tokens`` is 0 and ``output`` is None. Each request opens one
        :func:`repro_torch.tracing.request` record, which takes the cache's
        ``cache.*`` spans and counters."""
        if tenant not in self.tenants:
            raise KeyError(f"tenant {tenant!r} not admitted")
        with request():
            tokens = np.asarray(tokens, dtype=np.int64)
            self._next_id += 1
            look = self.cache.lookup(tenant, tokens)
            cached = look.cached_tokens
            suffix = len(tokens) - cached
            # write back the blocks we will prefill
            _, st = self.cache.insert(tenant, tokens, start_block=look.cached_blocks)
            evict = look.evictions + st.total_evictions
            ripple = look.ripple_evictions + st.total_ripple

            output = None
            if self.model is not None and self.params is not None:
                with torch.inference_mode():
                    batch = {"tokens": torch.as_tensor(tokens[None, :], device=self.device)}
                    cache_len = len(tokens) + max_new_tokens
                    logits, caches = self.model.prefill(self.params, batch, cache_len)
                    output = greedy_decode(
                        self.model, self.params, logits, caches,
                        start_pos=len(tokens), n_steps=max_new_tokens,
                    ).cpu().numpy()
            res = RequestResult(
                req_id=self._next_id,
                tenant=tenant,
                cached_tokens=cached,
                prefill_tokens=suffix,
                new_tokens=max_new_tokens if output is not None else 0,
                flops_saved=cached * self.flops_per_token_prefill(),
                evictions=evict,
                ripple_evictions=ripple,
                output=output,
            )
            self.results.append(res)
            return res

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        tot_cached = sum(r.cached_tokens for r in self.results)
        tot_prefill = sum(r.prefill_tokens for r in self.results)
        tot = max(tot_cached + tot_prefill, 1)
        return {
            "requests": len(self.results),
            "prefix_hit_token_ratio": tot_cached / tot,
            "flops_saved": sum(r.flops_saved for r in self.results),
            "evictions": sum(r.evictions for r in self.results),
            "ripple_evictions": sum(r.ripple_evictions for r in self.results),
            "sharing_ratio": self.cache.sharing_ratio(),
            "pool_used_blocks": self.pool.used_blocks,
            "pool_high_water": self.pool.high_water,
        }
