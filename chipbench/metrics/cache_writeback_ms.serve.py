"""cache_writeback_ms.serve: mean host ms of a window request's span
``cache.insert`` (the port's ``SharedPrefixCache.insert``, the write-back:
the block keys and a set a new block, with its evictions and pages)."""

from chipbench.harness.spans import mean_ms


def read(rec):
    return mean_ms(rec, "cache.insert")
