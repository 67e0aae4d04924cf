"""The cache key of the kernel build (`utils/cuda_build.py`), without `nvcc`.

A built library is named after a hash, and an edit that changes what `nvcc`
would produce has to change the name, or the old library is loaded again.
"""

import pytest

from pytheiasfm_tpu_torch.utils import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kernel.cu").write_text('#include "core.cuh"\nint f() { return ONE; }\n')
    (tmp_path / "core.cuh").write_text("#define ONE 1\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edited", ["kernel.cu", "core.cuh"])
def test_target_name_follows_source_and_header_bytes(csrc, edited):
    before = cuda_build._target("kernel")
    assert before.parent == cuda_build.BUILD_DIR and before.name.startswith("libkernel-")
    original = (csrc / edited).read_text()
    (csrc / edited).write_text(original + "// edited\n")
    assert cuda_build._target("kernel") != before
    (csrc / edited).write_text(original)
    assert cuda_build._target("kernel") == before


def test_target_name_follows_a_new_header_and_the_flags(csrc, monkeypatch):
    before = cuda_build._target("kernel")
    (csrc / "other.cuh").write_text("#define TWO 2\n")
    with_header = cuda_build._target("kernel")
    assert with_header != before
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", [*cuda_build.NVCC_FLAGS, "-lineinfo"])
    assert cuda_build._target("kernel") not in (before, with_header)


def test_the_port_kernels_include_only_hashed_headers():
    """Every `#include "..."` of a kernel source names a `csrc/*.cuh`, which
    the cache key covers."""
    hashed = {h.name for h in cuda_build.CSRC.glob("*.cuh")}
    sources = sorted(cuda_build.CSRC.glob("*.cu")) + sorted(cuda_build.CSRC.glob("*.cuh"))
    assert sources
    for src in sources:
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                assert line.split('"')[1] in hashed, (src.name, line)
