"""Math layer: graph algorithms (`graph.py`), robust linear solvers
(`l1.py`), box QP and constrained L1 (`qp.py`), block SDPs (`sdp.py`) and
the SPRT (`sprt.py`), as the JAX package's `math/` exports them."""

from . import graph  # noqa: F401
from . import qp  # noqa: F401
from . import sdp  # noqa: F401
from .l1 import admm_l1, irls_solve  # noqa: F401
from .qp import solve_box_qp, solve_constrained_l1  # noqa: F401
from .sdp import SDPSolverOptions, riemannian_staircase, solve_block_sdp  # noqa: F401
from .sprt import sequential_probability_ratio_test  # noqa: F401
