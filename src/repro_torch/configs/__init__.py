"""Architecture registry: one module per assigned architecture.

``get_config(name)`` / ``list_archs()`` are the public entry points;
``--arch <id>`` in the launchers resolves through them. Arch ids use
dashes (as assigned); module names use underscores.
"""

from .base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    ShapeConfig,
    get_config,
    list_archs,
    register,
    runnable,
)
