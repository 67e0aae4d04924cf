"""LM iterations a solve (the program's `BundleAdjustmentSummary`)."""


def read(run):
    return run.per_step(run.counters.get("lm_iterations"))
