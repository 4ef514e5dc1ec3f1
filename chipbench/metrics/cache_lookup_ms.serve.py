"""cache_lookup_ms.serve: mean host ms of a window request's span
``cache.lookup`` (the port's ``SharedPrefixCache.lookup``: the prompt's
block keys and the chain of MCD gets)."""

from chipbench.harness.spans import mean_ms


def read(rec):
    return mean_ms(rec, "cache.lookup")
