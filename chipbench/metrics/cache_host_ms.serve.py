"""cache_host_ms.serve: mean host ms a request of the window spends in
``engine.submit`` before the model's prefill starts (the prefix cache's
lookup and write-back), the benchmark's own span."""


def read(rec):
    t = rec.spans.get("cache_host") if rec.kind == "serve" else None
    return 1e3 * sum(t) / len(t) if t else None
