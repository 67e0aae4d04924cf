"""Write `tests/data/torch_two_view_verifier_jax.npz`: the JAX package's
`sfm/two_view.make_batched_verifier` on the clean pairs of
`tests/test_torch_two_view_verification.py`, which holds the port's
verifier to it (the JAX trace takes about 25 s, too long for a tier-1 test;
that module's `slow` test recomputes it).

Usage: JAX_PLATFORMS=cpu python tests/torch_verifier_reference.py
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

# As `tests/conftest.py` runs the tests.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import test_torch_two_view_verification as T  # noqa: E402

if __name__ == "__main__":
    T.save_verifier_record()
    print("wrote", T.VERIFIER_RECORD)
