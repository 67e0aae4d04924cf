"""The port's `parallel/` (`sharding`, `distributed`, `multihost`) on a CPU
mesh of 4 gloo ranks (2 nodes x 2), against one rank and against the JAX
package's mesh runs on the same inputs.

The 4 ranks start once for the module (`tests/torch_mesh_cases.py`, suite
"parallel"), run every case and hand their results back; the JAX package's
outputs are those recorded in `tests/data/torch_mesh_jax.npz` by
`tests/torch_mesh_reference.py` (its 8- and 4-device virtual CPU meshes),
so this module pays for no JAX trace. The counterparts of
`tests/test_multichip.py:27, :37` and `tests/test_multihost.py:172`.
"""

import numpy as np
import pytest
import torch

import torch_mesh_reference as ref
from torch_mesh_cases import run_suite

WORLD = 4


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    return run_suite("parallel", tmp_path_factory.mktemp("mesh"), WORLD)


@pytest.fixture(scope="module")
def ranks(suite):
    return suite[0]


@pytest.fixture(scope="module")
def single(suite):
    return suite[1]


@pytest.fixture(scope="module")
def record():
    return dict(np.load(ref.RECORD))


def test_make_mesh_and_its_shards(ranks):
    for r, res in enumerate(ranks):
        m = res["mesh"]
        assert (m["size"], m["index"], m["dim_names"]) == (WORLD, r, ("data",))
        assert m["replicated"] and m["sharded"]
        # 10 rows padded to 12 with zeros: rank r holds rows 3r..3r+2.
        want = np.concatenate([np.arange(10), [0, 0]])[3 * r:3 * r + 3]
        np.testing.assert_array_equal(m["shard"], want)
        np.testing.assert_array_equal(m["numpy_shard"], want.astype(float))
        np.testing.assert_array_equal(m["gathered"], np.arange(10))
        assert m["decided"] is True  # rank 0's truth value on every rank
        np.testing.assert_array_equal(m["summed"], WORLD * np.arange(10.0) + 600.0)
        np.testing.assert_array_equal(m["broadcast"], np.arange(10.0))


def test_make_mesh_needs_a_process_group():
    from pytheiasfm_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


@pytest.mark.parametrize("shape,multiple,axis", [((10, 3), 4, 0), ((8, 3), 4, 0),
                                                 ((5, 7), 8, 1), ((0,), 4, 0)])
def test_pad_to_multiple_is_the_jax_package_s(shape, multiple, axis):
    from pytheiasfm_tpu.parallel.sharding import pad_to_multiple as jax_pad
    from pytheiasfm_tpu_torch.parallel import pad_to_multiple

    a = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape) + 1
    got, n = pad_to_multiple(a, multiple, axis, fill=-1)
    want, n_want = jax_pad(a, multiple, axis, fill=-1)
    assert n == n_want == shape[axis]
    np.testing.assert_array_equal(got, want)


def test_sharded_segment_sum(ranks, single, record):
    for res in ranks:
        s = res["segsum"]
        np.testing.assert_allclose(s["out"], single["segsum"]["out"], rtol=1e-12)
        np.testing.assert_allclose(s["out"], record["jax__segsum__out"], rtol=1e-12)


def test_distributed_normal_equation_blocks(ranks, single, record):
    for res in ranks:
        b = res["blocks"]
        for name in ("U", "Vt", "bc", "bp"):
            np.testing.assert_allclose(b[name], single["blocks"][name], rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(b[name], record[f"jax__blocks__{name}"], rtol=1e-10,
                                       atol=1e-12)


def test_multihost_nodes_and_the_2d_mesh(ranks):
    for r, res in enumerate(ranks):
        m = res["multihost"]
        assert m["initialized"]
        assert m["info"] == (r // 2, 2, 2, WORLD)
        assert m["shape2"] == (2, 2) and m["names2"] == ("host", "chip")
        assert m["coordinate"] == (r // 2, r % 2)
        assert m["sum2"] == m["sum_flat"] == float(np.arange(16.0).sum())
        assert m["global_size"] == WORLD


def test_two_process_dense_ba_on_the_global_mesh(ranks, single, record):
    """`test_multihost.py:172`: the dense Schur on the global mesh of 2
    nodes x 2 ranks against one device (f64), and against the JAX package's
    4-device mesh at the port's dense-kernel parity bars."""
    s = single["two_process"]
    for res in ranks:
        m = res["two_process"]
        assert m["iterations"] == s["iterations"]
        np.testing.assert_allclose(m["ext"], s["ext"], rtol=0, atol=1e-8)
        np.testing.assert_allclose(m["cost"], s["cost"], rtol=1e-8, atol=1e-18)
        np.testing.assert_allclose(m["ext"], record["jax__two_process__ext_out"], rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(m["cost"], float(record["jax__two_process__cost"]),
                                   rtol=1e-8, atol=1e-18)


def test_every_rank_returns_the_same_bits(ranks):
    def replicated(res):
        out = {k: v for k, v in res.items() if k not in ("mesh", "multihost")}
        return {k: {n: x for n, x in v.items() if n != "seconds"} for k, v in out.items()}

    first = replicated(ranks[0])
    for res in ranks[1:]:
        other = replicated(res)
        for case, values in first.items():
            for name, value in values.items():
                np.testing.assert_array_equal(other[case][name], value, err_msg=f"{case}.{name}")


def test_collective_counts():
    """`collective_stats` counts every collective a `MeshAxis` runs (a
    1-rank gloo group in this process)."""
    import torch.distributed as dist

    from pytheiasfm_tpu_torch.parallel import make_mesh, mesh_axis, sharding

    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        ax = mesh_axis(make_mesh())
        sharding.reset_collective_stats(timing=True)
        ax.sum(torch.ones(3))
        ax.broadcast(torch.ones(3))
        ax.gather(torch.ones(3))
        assert ax.decide(torch.tensor(True))
        stats = dict(sharding.collective_stats)
        sharding.reset_collective_stats()
    finally:
        dist.destroy_process_group()
    assert (stats["all_reduce"], stats["broadcast"], stats["all_gather"]) == (1, 2, 1)
    assert stats["seconds"] > 0
