"""train_peak_gib: the allocator's peak over the window (reset at its
start), in GiB."""


def read(rec):
    if rec.kind != "train" or not rec.counters.get("window_peak_bytes"):
        return None
    return rec.counters["window_peak_bytes"] / 2**30
