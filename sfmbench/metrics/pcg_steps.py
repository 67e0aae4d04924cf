"""PCG steps a solve, over all its LM iterations (the program's `BundleAdjustmentSummary`)."""


def read(run):
    return run.per_step(run.counters.get("pcg_steps"))
