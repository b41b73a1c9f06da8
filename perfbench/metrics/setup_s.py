"""Seconds from the process's start to the window's start: imports, the
corpus, the stack, the weights, the kernel build (first run in a
checkout only) and the warm-up."""


def read(rec):
    return rec["setup_s"]
