"""prefill_mfu.serve: the window's prefill model FLOPs (2 x active
parameters x tokens + attention) over the prefills' synchronised host
time and the bf16 peak, %."""

from chipbench.harness.yardstick import PEAK_FLOPS


def read(rec):
    t = rec.spans.get("prefill") if rec.kind == "serve" else None
    if not t or sum(t) <= 0:
        return None
    return 100.0 * rec.work["prefill_flops"] * len(t) / sum(t) / PEAK_FLOPS["bfloat16"]
