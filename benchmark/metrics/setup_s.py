"""Seconds from the process's start to the first timed call: imports, the
model, weights and inputs, the kernels' build or load, the warm-up calls."""


def read(ctx):
    return ctx["setup_s"]
