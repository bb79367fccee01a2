"""Set-up: from the process's start to the window's (imports, the kernel
build or load, weights, traffic, warm-up)."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "s", "lower", "host_clock", "set-up", None


def read(run):
    return run.setup_s
