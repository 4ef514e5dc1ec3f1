"""ttft_ms_p90: the 90th percentile (linear) over every request of the
window of the time from ``engine.submit`` to the synchronised end of its
prefill, in ms."""

import numpy as np


def read(rec):
    t = rec.spans.get("ttft") if rec.kind == "serve" else None
    return float(np.percentile(t, 90)) * 1e3 if t else None
