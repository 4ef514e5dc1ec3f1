"""setup_s: seconds from the process's start to the window's (imports,
kernel loads, weights drawn from the seed, the warm-up steps or requests)."""


def read(rec):
    return rec.setup_s
