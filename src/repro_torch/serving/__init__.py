"""Multi-tenant serving: the engine (accounting and live mode), the
sampler of its live decode, and, loaded on first use (PEP 562) as the
reference loads them, the trace compiler (``trace``) and the cost layer
(``costs``)."""

from .engine import (  # noqa: F401
    EngineConfig,
    Request,
    RequestResult,
    ServingEngine,
    TenantSpec,
)
from .sampler import greedy_decode, sample_token  # noqa: F401

_LAZY = {
    "ServingLayout": ".trace",
    "compile_trace": ".trace",
    "serving_rates": ".trace",
    "ServingCostModel": ".costs",
    "cell_costs": ".costs",
    "prefill_flops_per_token": ".costs",
}

__all__ = sorted(["EngineConfig", "Request", "RequestResult", "ServingEngine", "TenantSpec",
                  "greedy_decode", "sample_token", *_LAZY])


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
