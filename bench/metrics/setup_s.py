"""setup_s: process start to the first timed request (kernel build or load,
inputs, warm-up)."""


def read(run):
    return run.setup_s
