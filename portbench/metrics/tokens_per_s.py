"""Tokens the window's completed steps or batches consumed (batch x
sequence), over the window's wall time."""


def read(run):
    return run.window["tokens"] / run.window["seconds"]
