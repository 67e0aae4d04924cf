"""Seconds from process start to the window: imports, inputs, copies,
the warm step."""


def read(run):
    return run.setup_s
