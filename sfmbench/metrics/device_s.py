"""Device seconds a step in the traced window: the summed time of its
device operations."""


def read(run):
    return None if run.trace is None else run.per_step(run.trace.device_s)
