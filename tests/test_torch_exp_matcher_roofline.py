"""K2, the matcher's roofline probe: the port's `matmul_rowmin` on CPU tensors
(its plain version) against the JAX tool's Pallas kernel
(`tools/exp_matcher_roofline.py`, `make(64, 64, D, None)`) run in TPU
interpret mode, on the same bf16 inputs made with numpy from a seed.

The tool is loaded by file path and its grid globals cut to P = 2, N = 128
(the grid reads them). Tolerance: max |delta| <= 1e-4 * (1 + |ref|); both
sum exact bf16 products in f32, in another order.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pytheiasfm_tpu_torch.tools import exp_matcher_roofline as k2

TOOL = Path(__file__).resolve().parent.parent / "tools" / "exp_matcher_roofline.py"


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("_jax_exp_matcher_roofline", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("D", [128, 256])
def test_matmul_rowmin_matches_the_pallas_kernel(tool, monkeypatch, D):
    monkeypatch.setattr(tool, "P", 2)
    monkeypatch.setattr(tool, "N", 128)
    rng = np.random.default_rng(D)
    d1 = rng.normal(size=(2, 128, D)).astype(np.float32)
    d2t = rng.normal(size=(2, D, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            tool.make(64, 64, D, None)(
                jnp.asarray(d1).astype(jnp.bfloat16), jnp.asarray(d2t).astype(jnp.bfloat16)
            )
        )
    before = k2.matmul_rowmin.launches
    got = k2.matmul_rowmin(torch.tensor(d1).bfloat16(), torch.tensor(d2t).bfloat16())
    assert k2.matmul_rowmin.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (2, 128)
    got = got.numpy()
    assert np.all(np.abs(got - want) <= 1e-4 * (1 + np.abs(want))), np.abs(got - want).max()


def test_reference_clamps_to_the_tpu_initial_value():
    """Rows whose products all exceed 3.4e38 come out at 3.4e38, the TPU
    kernel's initial row minimum, not at +inf."""
    d1 = torch.full((1, 64, 64), 1e20)
    d2t = torch.full((1, 64, 64), 1e20)
    out = k2.matmul_rowmin_reference(d1, d2t)
    assert torch.all(out == torch.tensor(k2.BIG, dtype=torch.float32))


def test_sweep_inputs_and_cpu_refusal():
    d1, d2t = k2.inputs(128, device="cpu", pairs=1, n=64)
    assert d1.shape == (1, 64, 128) and d2t.shape == (1, 128, 64)
    assert d1.dtype == d2t.dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            k2.sweep(iters=1)
