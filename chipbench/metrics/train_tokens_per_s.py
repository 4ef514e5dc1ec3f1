"""train_tokens_per_s: every token of every step the window finished,
over the window's seconds (host clock)."""


def read(rec):
    if rec.kind != "train" or rec.window_s <= 0:
        return None
    return rec.counters["window_tokens"] / rec.window_s
