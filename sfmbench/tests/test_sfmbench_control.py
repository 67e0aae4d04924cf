"""The check's control and planted faults, each a `--variant` of a whole run
at a size a test run holds: the program as the configuration states it
(f64) reads within every limit; its own f32 path, the control, and each
fault the cell can have read outside one, so `correct` comes out false.
One chip: no exchange between chips to leave out."""

from __future__ import annotations

import pytest

from sfmbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_the_program_as_configured_reads_correct(capsys, root, seed):
    code, line = tiny.run(root, "ba.bal_tiny", seed=seed, capsys=capsys)
    assert code == 0 and line["correct"] is True
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("variant,fails", [
    ("float32", "cost_gap"),     # the control: f32 observations round the cost
    ("unchanged", "ba_excess"),  # a solve that returns its start state
    ("half", "cost_gap"),        # half the batch left out, the cost over the rest
    ("altered", "ba_point_gap"),  # a returned point altered where it is written
])
@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_the_control_and_each_fault_read_not_correct(capsys, root, seed, variant, fails):
    code, line = tiny.run(root, "ba.bal_tiny", seed=seed, capsys=capsys, variant=variant)
    assert code == 0 and line["correct"] is False
    assert line["checks"][fails]["value"] > line["checks"][fails]["limit"]


def test_an_unknown_variant_is_refused(capsys, root):
    code, line = tiny.run(root, "ba.bal_tiny", capsys=capsys, variant="nothing")
    assert code != 0 and line is None
