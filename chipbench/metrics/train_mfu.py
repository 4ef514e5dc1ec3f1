"""train_mfu: the window's model FLOPs (6 x active parameters x tokens +
attention, the yardstick's count) over its seconds and the bf16 peak, %."""

from chipbench.harness.yardstick import PEAK_FLOPS


def read(rec):
    if rec.kind != "train" or rec.window_s <= 0:
        return None
    flops = rec.work["step_flops"] * rec.counters["window_steps"]
    return 100.0 * flops / rec.window_s / PEAK_FLOPS["bfloat16"]
