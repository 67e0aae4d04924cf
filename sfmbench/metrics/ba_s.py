"""Seconds a bundle-adjustment solve takes in the window, its in-place
restore of the start state included: the whole window over the solves
completed in it."""


def read(run):
    return run.per_step(run.window_s)
