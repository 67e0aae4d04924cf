"""pytheiasfm_tpu_torch — the PyTorch/CUDA port of `pytheiasfm_tpu`.

Module paths mirror the JAX package (`matching/matcher.py` here is the
counterpart of `pytheiasfm_tpu/matching/matcher.py`). The port imports
`torch` and numpy only: never `jax`, and nothing of the JAX package. The
Pallas kernels of the JAX package become CUDA kernels written by hand for
Hopper (`csrc/`), each with a plain PyTorch version beside it that the
wrapper runs for tensors on the CPU.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometric vision is precision-critical: the minimal solvers lose most of
# their recoveries in reduced-precision matmuls. The JAX package forces true
# f32 multiplies (`pytheiasfm_tpu/__init__.py`); on the GPU that means TF32
# off for matmuls and convolutions. Only the descriptor-matching kernel
# opts into bf16, as its Pallas counterpart does.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def default_device(device=None) -> _torch.device:
    """Resolve an entry point's ``device`` argument: ``None`` means the
    CUDA card, which must then be present."""
    if device is None:
        if not _torch.cuda.is_available():
            raise RuntimeError(
                "pytheiasfm_tpu_torch runs on a CUDA card by default and none "
                "is available; pass device=\"cpu\" to run on the CPU"
            )
        return _torch.device("cuda")
    return _torch.device(device)


# The JAX package's top level imports these two subpackages; after
# `default_device`, which their modules import from here.
from . import models, ops  # noqa: E402,F401
