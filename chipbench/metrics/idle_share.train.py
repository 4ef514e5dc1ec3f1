"""idle_share.train: the share of a window step's host-clock time in which
no operation ran on the card, %: one minus the device-busy seconds of a
profiled step (the trace) over the untraced window's seconds a step. The
profiler's own host time stretches the profiled steps' wall time, so
their wall clock is not the denominator."""


def read(rec):
    if rec.profile is None or rec.kind != "train" or not rec.counters.get("window_steps"):
        return None
    busy = rec.profile.busy_s("step") / rec.counters["profiled_steps"]
    step = rec.window_s / rec.counters["window_steps"]
    return 100.0 * (1.0 - busy / step) if busy > 0 else None
