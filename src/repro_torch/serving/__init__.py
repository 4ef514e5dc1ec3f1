"""Multi-tenant serving: the engine (accounting and live mode) and the
sampler of its live decode."""

from .engine import (  # noqa: F401
    EngineConfig,
    Request,
    RequestResult,
    ServingEngine,
    TenantSpec,
)
from .sampler import greedy_decode, sample_token  # noqa: F401
