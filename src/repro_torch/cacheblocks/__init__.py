"""Device-side physical cache: paged KV pool + tenant-facing prefix
cache backed by the paper's object-sharing LRU manager.

Names resolve lazily (PEP 562), as in the reference package: importing
``kv_layout`` for the layout math does not load the pool.
"""

_LAZY = {
    "KVLayout": ".kv_layout",
    "layout_for": ".kv_layout",
    "BlockPool": ".block_pool",
    "SharedPrefixCache": ".prefix_cache",
    "PrefixLookup": ".prefix_cache",
    "InsertStats": ".prefix_cache",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
