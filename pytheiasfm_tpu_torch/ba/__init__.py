"""Bundle adjustment. Counterpart of the JAX package's `ba/`: so far the
robust losses (`losses.py`) and the two-view refinements (`two_view.py`)
that two-view verification runs; the full-scene solvers port with the
main path."""

from . import losses, two_view  # noqa: F401
from .losses import LossFunctionType  # noqa: F401
