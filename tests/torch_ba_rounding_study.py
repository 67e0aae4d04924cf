"""How rounding moves the iterative-Schur BA on the coarse-level test scene,
in the JAX package and in the port, on the CPU (f64).

    JAX_PLATFORMS=cpu python tests/torch_ba_rounding_study.py [--changes N] [--nojit]
    JAX_PLATFORMS=cpu python tests/torch_ba_rounding_study.py --part f32

Part "coarse" (the default). The scene is `tests/test_dense_schur._make_problem(default_rng(42), V=1024,
T=1500, L=4, noise=0.3, perturb=0.005)`, the coarse case of
`tests/test_iterative_schur.py` and `tests/test_torch_bundle_adjustment.py`:
about six observations a view, so some Schur-Jacobi blocks are nearly
singular at small damping. The port inverts those 6x6 blocks by pivoted
LU; the JAX kernel by the closed form `inv_small_spd` (a 3+3 block Schur on
adjugates). "port, closed form" below is the port with the closed form put
back. Prints:

1. steps: along the JAX kernel's own path, each package's LM step from
   the same state (cost after the step, accepted or not; the port's PCG
   iterations);
2. inverse: at the state after five steps, the blocks' condition numbers
   and the error of each inverse applied to the PCG right-hand side, against
   a long-double Gaussian elimination with partial pivoting;
3. accept: from that state, over N relative changes of 1e-15 of the points,
   how often each variant accepts its sixth step;
4. spread: over N such changes of the input, the cost after the JAX test's
   25 iterations (function tolerance 0) of each variant (`--nojit` adds the
   JAX kernel run op by op, a few minutes a run).

Part "f32": the reference-default entry in f32 on the scene of
`tests/test_torch_bundle_adjustment.test_entry_f32_defaults`: the port's
LM iterations one by one (damping, the proposal's cost and relative
change, accepted or not), the JAX package's cost after 1, 2, ... of its
iterations, and both packages' iteration counts on eight scene seeds.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

from pytheiasfm_tpu.ba import iterative_schur as jis  # noqa: E402
from pytheiasfm_tpu.ba.lm import BundleAdjustmentOptions as JOptions  # noqa: E402
from pytheiasfm_tpu.ba.lm import inv_small_spd as j_inv  # noqa: E402
from pytheiasfm_tpu_torch.ba import iterative_schur as tis  # noqa: E402
from pytheiasfm_tpu_torch.ba.lm import inv_small_spd as t_inv  # noqa: E402
from test_dense_schur import _make_problem  # noqa: E402
from test_torch_bundle_adjustment import (  # noqa: E402
    _entry_scene,
    _kernel_inputs,
    _reference_default_options,
    _t_options,
)

ONE_STEP = JOptions(max_num_iterations=1, function_tolerance=0.0)
FULL = JOptions(max_num_iterations=25, function_tolerance=0.0)
_inv_ex = torch.linalg.inv_ex


@contextlib.contextmanager
def closed_form():
    """The port with the JAX kernel's closed-form 6x6 inverse."""
    def inv_ex(A, **kw):
        if A.shape[-1] == 6:
            return t_inv(A, 6), None
        return _inv_ex(A, **kw)
    torch.linalg.inv_ex = inv_ex
    try:
        yield
    finally:
        torch.linalg.inv_ex = _inv_ex


def changed(points, seed):
    """The points times (1 + 1e-15 N(0, 1)), from `seed`."""
    return points * (1 + 1e-15 * np.random.default_rng(seed).normal(size=points.shape))


class Scene:
    def __init__(self):
        p = _make_problem(np.random.default_rng(42), V=1024, T=1500, L=4, noise=0.3,
                          perturb=0.005)
        self.args, self.kw = _kernel_inputs(p)
        self.rest = self.args[3:]

    def jax_step(self, state, mu):
        """The JAX kernel's LM step: (state after, accepted, mu after, cost after)."""
        e, q, pt, s = jis._bundle_adjust_iterative_impl(
            *(jnp.asarray(x) for x in state), *(jnp.asarray(a) for a in self.rest),
            options=ONE_STEP, mu0=mu, **self.kw)
        accepted = float(s.final_cost) < float(s.initial_cost)
        return [np.asarray(x) for x in (e, q, pt)], accepted, float(s.final_mu), float(s.final_cost)

    def port_step(self, state, mu):
        """The port's LM proposal: (proposal's cost, PCG iterations, the
        Schur-Jacobi blocks, the PCG right-hand side)."""
        seen = {}
        pcg = tis._pcg

        def keep(S_mv, precond, g, options, comm=None):
            seen["g"] = g[0]
            return pcg(S_mv, precond, g, options, comm)

        def inv_ex(A, **kw):
            seen["Mv"] = A
            return inv_now(A, **kw)

        inv_now = torch.linalg.inv_ex
        st = tuple(torch.as_tensor(x) for x in state)
        prob = tis._Problem(*st, *(torch.as_tensor(a) for a in self.rest), **self.kw,
                            options=_t_options(ONE_STEP))
        tis._pcg, torch.linalg.inv_ex = keep, inv_ex
        try:
            new, _, _, n_pcg = prob.lm_step(st, torch.tensor(mu, dtype=torch.float64))
        finally:
            tis._pcg, torch.linalg.inv_ex = pcg, inv_now
        return float(prob.cost_of(new)), n_pcg, seen["Mv"].numpy(), seen["g"].numpy()

    def jax_full(self, points):
        args = list(self.args)
        args[2] = points
        *_, s = jis.bundle_adjust_iterative(*(jnp.asarray(a) for a in args), options=FULL,
                                            **self.kw)
        return float(s.final_cost)

    def port_full(self, points):
        args = list(self.args)
        args[2] = points
        *_, s = tis.bundle_adjust_iterative(*(torch.as_tensor(a) for a in args),
                                            options=_t_options(FULL), **self.kw)
        return s.final_cost


def solve_long_double(A, b):
    """Batched Gaussian elimination with partial pivoting in long double."""
    A = A.astype(np.longdouble)
    b = b.astype(np.longdouble)
    n, idx = A.shape[-1], np.arange(len(A))
    for k in range(n):
        piv = k + np.abs(A[:, k:, k]).argmax(1)
        A[idx, k], A[idx, piv] = A[idx, piv].copy(), A[idx, k].copy()
        b[idx, k], b[idx, piv] = b[idx, piv].copy(), b[idx, k].copy()
        f = A[:, k + 1:, k] / A[:, k, k][:, None]
        A[:, k + 1:, :] -= f[..., None] * A[:, k, None, :]
        b[:, k + 1:] -= f * b[:, k, None]
    x = np.zeros_like(b)
    for k in range(n - 1, -1, -1):
        x[:, k] = (b[:, k] - (A[:, k, k + 1:] * x[:, k + 1:]).sum(1)) / A[:, k, k]
    return x.astype(np.float64)


def f32_entry():
    from pytheiasfm_tpu.ba import entry as jentry
    from pytheiasfm_tpu.utils.synthetic import random_reconstruction
    from pytheiasfm_tpu_torch import convert
    from pytheiasfm_tpu_torch.ba import entry as tentry

    jopt, topt = _reference_default_options()
    trace = []
    step, cost_of = tis._Problem.lm_step, tis._Problem.cost_of

    def traced_step(self, state, mu):
        trace.append(["step", float(mu)])
        return step(self, state, mu)

    def traced_cost(self, state):
        c = cost_of(self, state)
        trace.append(["cost", float(c)])
        return c

    tis._Problem.lm_step, tis._Problem.cost_of = traced_step, traced_cost
    try:
        ts = tentry.bundle_adjust_reconstruction(
            topt, convert.reconstruction(_entry_scene(True)), dtype=np.float32, device="cpu")
    finally:
        tis._Problem.lm_step, tis._Problem.cost_of = step, cost_of
    print(f"port: {ts.num_iterations} iterations, cost {ts.initial_cost!r} -> {ts.final_cost!r}")
    cost = trace[0][1]
    for (_, mu), (_, new) in zip(trace[1::2], trace[2::2]):
        print(f"  mu {mu:.4e}: proposal {new!r}, relative change {abs(new - cost) / cost:.3e}, "
              f"{'accepted' if new < cost else 'rejected'}")
        cost = min(cost, new)
    js = jentry.bundle_adjust_reconstruction(jopt, _entry_scene(True), dtype=np.float32)
    n = int(js.num_iterations)
    print(f"JAX: {n} iterations, cost {float(js.initial_cost)!r} -> {float(js.final_cost)!r}")
    for k in range(1, n + 1):
        s = jentry.bundle_adjust_reconstruction(
            dataclasses.replace(jopt, max_num_iterations=k), _entry_scene(True),
            dtype=np.float32)
        print(f"  after {k}: cost {float(s.final_cost)!r}")
    print("iterations on eight scenes (seed: JAX, port; final costs)")
    for seed in range(5, 13):
        def scene():
            recon = random_reconstruction(num_views=8, num_tracks=150, seed=seed,
                                          pixel_noise=0.3)
            rng = np.random.default_rng(seed + 4)
            recon.view_extrinsics[1:, :3] += rng.normal(size=(7, 3)) * 0.02
            recon.view_extrinsics[1:, 3:] += rng.normal(size=(7, 3)) * 0.002
            recon.points[:, :3] += rng.normal(size=(150, 3)) * 0.02
            recon.intrinsics[:, 0] *= 1.0 + rng.normal(size=len(recon.intrinsics)) * 0.01
            recon.view_group[:] = 0
            return recon
        js = jentry.bundle_adjust_reconstruction(jopt, scene(), dtype=np.float32)
        ts = tentry.bundle_adjust_reconstruction(
            topt, convert.reconstruction(scene()), dtype=np.float32, device="cpu")
        print(f"  {seed}: {int(js.num_iterations)}, {ts.num_iterations}; "
              f"{float(js.final_cost)!r}, {ts.final_cost!r}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--part", choices=("coarse", "f32"), default="coarse")
    parser.add_argument("--changes", type=int, default=16,
                        help="input changes of 1e-15 for the accept and spread parts")
    parser.add_argument("--nojit", action="store_true",
                        help="also run the JAX kernel op by op in the spread part")
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    if args.part == "f32":
        f32_entry()
        return 0
    sc = Scene()

    print("1. steps along the JAX kernel's path", flush=True)
    state = [np.asarray(a) for a in sc.args[:3]]
    mu = 1.0 / ONE_STEP.initial_trust_region_radius
    for k in range(12):
        port_cost, pcg, _, _ = sc.port_step(state, mu)
        new, accepted, mu_next, jax_cost = sc.jax_step(state, mu)
        print(f"  step {k}: mu {mu:.4e}; JAX {'accepts' if accepted else 'rejects'}, cost "
              f"{jax_cost!r}; the port's proposal {port_cost!r} ({pcg} PCG iterations)",
              flush=True)
        if k == 4:
            state5, mu5, cost5 = new, mu_next, jax_cost
        state, mu = new, mu_next

    print(f"2. inverse of the Schur-Jacobi blocks after five steps (mu {mu5:.4e})", flush=True)
    _, _, Mv, g = sc.port_step(state5, mu5)
    cond = np.linalg.cond(Mv)
    print(f"  condition numbers: median {np.median(cond):.3e}, max {cond.max():.3e}")
    ref = solve_long_double(Mv, g)
    scale = np.abs(ref).max()
    inverses = {
        "closed form, JAX jitted": np.asarray(jax.jit(lambda a: j_inv(a, 6))(jnp.asarray(Mv))),
        "closed form, JAX op by op": np.asarray(j_inv(jnp.asarray(Mv), 6)),
        "closed form, port": t_inv(torch.as_tensor(Mv), 6).numpy(),
        "pivoted LU, port": _inv_ex(torch.as_tensor(Mv))[0].numpy(),
    }
    for name, inv in inverses.items():
        err = np.abs(np.einsum("vij,vj->vi", inv, g) - ref)
        print(f"  {name}: error of the preconditioned right-hand side, max "
              f"{err.max() / scale:.3e}, rms {np.sqrt((err ** 2).mean()) / scale:.3e} "
              f"(of its largest entry)", flush=True)

    n = args.changes
    print(f"3. the sixth step from that state, over {n} changes of 1e-15 of the points",
          flush=True)
    counts = {"JAX": 0, "port, pivoted LU": 0, "port, closed form": 0}
    for seed in range(n):
        st = [state5[0], state5[1], changed(state5[2], seed)]
        counts["JAX"] += sc.jax_step(st, mu5)[1]
        counts["port, pivoted LU"] += sc.port_step(st, mu5)[0] < cost5
        with closed_form():
            counts["port, closed form"] += sc.port_step(st, mu5)[0] < cost5
    for name, c in counts.items():
        print(f"  {name}: accepts {c} of {n}", flush=True)

    print(f"4. cost after 25 iterations, over {n} changes of 1e-15 of the input points",
          flush=True)
    runs = {"JAX jitted": [], "port, pivoted LU": [], "port, closed form": []}
    if args.nojit:
        runs["JAX op by op"] = []
    for seed in range(-1, n):
        pts = sc.args[2] if seed < 0 else changed(sc.args[2], seed)
        row = {"JAX jitted": sc.jax_full(pts), "port, pivoted LU": sc.port_full(pts)[0]}
        with closed_form():
            row["port, closed form"] = sc.port_full(pts)[0]
        if args.nojit:
            with jax.disable_jit():
                row["JAX op by op"] = sc.jax_full(pts)
        for k, v in row.items():
            runs[k].append(v)
        print(f"  change {seed}: " + ", ".join(f"{k} {v!r}" for k, v in row.items()),
              flush=True)
    best = min(min(v) for v in runs.values())
    for name, v in runs.items():
        v = np.asarray(v)
        slow = v > best * (1 + 1e-4)
        print(f"  {name}: {len(v)} runs, {slow.sum()} above the best by more than 1e-4 "
              f"(the slow regime); range {float(v.min())!r} .. {float(v.max())!r}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
