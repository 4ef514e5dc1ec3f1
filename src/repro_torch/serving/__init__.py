"""Multi-tenant serving: the engine, in accounting mode."""

from .engine import (  # noqa: F401
    EngineConfig,
    Request,
    RequestResult,
    ServingEngine,
    TenantSpec,
)
