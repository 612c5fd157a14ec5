"""Set-up seconds: from the process's start to the window's, on the host
clock: imports, the card's context, the inputs made from the seed, the
renderer, and the warm-up steps (the kernels' build in a checkout's first
run)."""


def read(records):
    return records["setup_s"]
