"""cache_keys_ms.serve: mean host ms a window request spends hashing its
prompt's block keys, its ``cache.keys`` spans summed (one inside the
lookup, one inside the write-back)."""

from chipbench.harness.spans import mean_ms


def read(rec):
    return mean_ms(rec, "cache.keys")
