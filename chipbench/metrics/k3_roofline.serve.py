"""k3_roofline.serve: K3's launches in the profiled prefills at their
bound (the yardstick's true work) over their device time, %."""


def read(rec):
    if rec.profile is None or rec.kind != "serve":
        return None
    sec, n, _ = rec.profile.group("K3", "prefill")
    return 100.0 * n * rec.work["k3_bound_ms"] * 1e-3 / sec if n and sec > 0 else None
