"""From the run's start (before ``import torch``) to the window's first
step: imports, loading or building the kernels, making the weights on the
card, the warm-up steps."""


def read(run):
    return run.setup_s
