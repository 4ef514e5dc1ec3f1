"""moe_route_ms.train: device ms a step of the kernels launched in the
``train_step.moe_route`` ranges (the MoE's routing, and remat's second
routing in the backward; the profiled steps)."""


def read(rec):
    if rec.profile is None or rec.kind != "train":
        return None
    s = rec.profile.range_s("train_step.moe_route", "step")
    return 1e3 * s / rec.counters["profiled_steps"] if s > 0 else None
