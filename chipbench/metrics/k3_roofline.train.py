"""k3_roofline.train: K3's launches in the profiled steps (forward and
remat's second forward, each writing its lse) at their bound (the
yardstick's true work) over their device time, %."""


def read(rec):
    if rec.profile is None or rec.kind != "train":
        return None
    sec, n, _ = rec.profile.group("K3", "step")
    return 100.0 * n * rec.work["k3_bound_ms"] * 1e-3 / sec if n and sec > 0 else None
