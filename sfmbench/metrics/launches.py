"""Kernel launches a step in the traced window (device operations but
copies and sets)."""


def read(run):
    return None if run.trace is None else run.per_step(run.trace.launches)
