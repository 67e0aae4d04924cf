"""The reference's own Gauss-Newton steps on a bundle-adjustment problem.

From a state (cameras, intrinsics groups, Euclidean points) it forms the
Jacobian of the reprojection residuals by forward-mode differentiation of
`geometry.project`, eliminates the points exactly (Schur complement), solves
the reduced camera-and-intrinsics system densely by Cholesky, and takes the
step, damped only where a step would raise the cost. Near a minimum two such
steps land on it to within rounding, so the lowest cost they reach is the
reference's optimum next to the state: a state that a solver claims as
converged has to cost no more than that, and a solver's reported cost has
to equal it.

The reduced system is dense, [6 V + k G] square for V cameras and G groups
of k free intrinsics each; the point blocks enter it through a dense matrix
of a chunk of tracks at a time, so the memory is bounded by `track_chunk`.
"""

from __future__ import annotations

import torch

from .geometry import cost, project, residuals


def _jacobians(ext, intr, X, obs_view, obs_group, obs_track, obs_uv, free_slots, chunk):
    """Residuals r [O, 2] and Jacobians with respect to the camera [O, 2, 6],
    the free intrinsics [O, 2, k] and the point [O, 2, 3]."""
    k = len(free_slots)
    sel = torch.zeros((k, intr.shape[1]), dtype=intr.dtype, device=intr.device)
    sel[torch.arange(k), torch.as_tensor(free_slots)] = 1.0
    keep = 1.0 - sel.sum(0)

    def one(e, qf, x, q, uv):
        return project(e, q * keep + qf @ sel, x) - uv

    jac = torch.func.vmap(torch.func.jacfwd(one, argnums=(0, 1, 2)))
    rs, jcs, jqs, jps = [], [], [], []
    for s in range(0, len(obs_view), chunk):
        v, g, t = obs_view[s:s + chunk], obs_group[s:s + chunk], obs_track[s:s + chunk]
        q = intr[g]
        qf = q[:, free_slots]
        jc, jq, jp = jac(ext[v], qf, X[t], q, obs_uv[s:s + chunk])
        rs.append(project(ext[v], q, X[t]) - obs_uv[s:s + chunk])
        jcs.append(jc)
        jqs.append(jq)
        jps.append(jp)
    return torch.cat(rs), torch.cat(jcs), torch.cat(jqs), torch.cat(jps)


def gauss_newton_step(ext, intr, X, obs, free_slots, mu, chunk=1 << 18, track_chunk=4096):
    """One damped Gauss-Newton step from (ext [V, 6], intr [G, P], X [T, 3])
    on the observations `obs` = (view, group, track, uv), rows sorted by
    track. Returns the stepped (ext, intr, X)."""
    obs_view, obs_group, obs_track, obs_uv = obs
    V, G, T = ext.shape[0], intr.shape[0], X.shape[0]
    k = len(free_slots)
    D = 6 * V + k * G
    dev, dt = ext.device, ext.dtype
    r, Jc, Jq, Jp = _jacobians(ext, intr, X, obs_view, obs_group, obs_track, obs_uv,
                               free_slots, chunk)
    Jy = torch.cat([Jc, Jq], dim=2)  # [O, 2, 6 + k]
    cols = torch.cat([6 * obs_view[:, None] + torch.arange(6, device=dev),
                      6 * V + k * obs_group[:, None] + torch.arange(k, device=dev)], dim=1)
    S = torch.zeros(D * D, dtype=dt, device=dev)
    for s in range(0, len(obs_view), chunk):
        c, J = cols[s:s + chunk], Jy[s:s + chunk]
        S.index_add_(0, (c[:, :, None] * D + c[:, None, :]).reshape(-1),
                     torch.einsum("oai,oaj->oij", J, J).reshape(-1))
    S = S.view(D, D)
    gy = torch.zeros(D, dtype=dt, device=dev)
    gy.index_add_(0, cols.reshape(-1), torch.einsum("oai,oa->oi", Jy, r).reshape(-1))
    Vt = torch.zeros((T, 3, 3), dtype=dt, device=dev)
    Vt.index_add_(0, obs_track, torch.einsum("oai,oaj->oij", Jp, Jp))
    gp = torch.zeros((T, 3), dtype=dt, device=dev)
    gp.index_add_(0, obs_track, torch.einsum("oai,oa->oi", Jp, r))
    W = torch.einsum("oai,oaj->oij", Jy, Jp)  # [O, 6 + k, 3]
    L = torch.linalg.cholesky(Vt + 1e-12 * torch.eye(3, dtype=dt, device=dev))

    # Eliminate the points: S -= A^T A and gy -= A^T c, chunk by chunk of
    # tracks, where A's three rows of track t are L_t^-1 W_t^T.
    bounds = torch.searchsorted(obs_track, torch.arange(0, T + track_chunk, track_chunk,
                                                        device=dev).clamp(max=T))
    bounds = bounds.tolist()
    for i, t0 in enumerate(range(0, T, track_chunk)):
        t1 = min(t0 + track_chunk, T)
        o0, o1 = bounds[i], bounds[i + 1]
        tr = obs_track[o0:o1]
        B = torch.linalg.solve_triangular(L[tr], W[o0:o1].transpose(1, 2), upper=False)
        A = torch.zeros((3 * (t1 - t0) * D,), dtype=dt, device=dev)
        rows = 3 * (tr - t0)[:, None, None] + torch.arange(3, device=dev)[None, :, None]
        A.index_add_(0, (rows * D + cols[o0:o1, None, :]).reshape(-1), B.reshape(-1))
        A = A.view(3 * (t1 - t0), D)
        cvec = torch.linalg.solve_triangular(L[t0:t1], gp[t0:t1, :, None], upper=False)
        S -= A.T @ A
        gy -= A.T @ cvec.reshape(-1)
    diag = torch.diagonal(S)
    Sd = S + torch.diag(mu * diag + 1e-12 * diag.max())
    dy = -torch.cholesky_solve(gy[:, None], torch.linalg.cholesky(Sd))[:, 0]
    rhs = gp.clone()
    rhs.index_add_(0, obs_track, torch.einsum("oij,oi->oj", W, dy[cols]))
    dp = -torch.cholesky_solve(rhs[:, :, None], L)[:, :, 0]
    new_intr = intr.clone()
    new_intr[:, free_slots] += dy[6 * V:].view(G, k)
    return ext + dy[:6 * V].view(V, 6), new_intr, X + dp


def refine_points(ext, intr, X, obs, steps=2):
    """The lowest cost that `steps` Gauss-Newton steps of the points alone
    reach from the state, the cameras and intrinsics held (each point's own
    3x3 system; a point whose step raises its part of the cost keeps its
    place). Returns (cost at the state, lowest cost)."""
    obs_view, obs_group, obs_track, obs_uv = obs
    T = X.shape[0]

    def per_track(Xc):
        r = residuals(ext, intr, Xc, obs_view, obs_group, obs_track, obs_uv)
        c = torch.zeros(T, dtype=X.dtype, device=X.device)
        return c.index_add_(0, obs_track, 0.5 * torch.sum(r * r, dim=1))

    def one(x, e, q, uv):
        return project(e, q, x) - uv

    jac = torch.func.vmap(torch.func.jacfwd(one))
    costs = per_track(X)
    start = float(costs.sum())
    for _ in range(steps):
        Jp = jac(X[obs_track], ext[obs_view], intr[obs_group], obs_uv)
        r = project(ext[obs_view], intr[obs_group], X[obs_track]) - obs_uv
        Vt = torch.zeros((T, 3, 3), dtype=X.dtype, device=X.device)
        Vt.index_add_(0, obs_track, torch.einsum("oai,oaj->oij", Jp, Jp))
        gp = torch.zeros((T, 3), dtype=X.dtype, device=X.device)
        gp.index_add_(0, obs_track, torch.einsum("oai,oa->oi", Jp, r))
        eye = torch.eye(3, dtype=X.dtype, device=X.device)
        L, _ = torch.linalg.cholesky_ex(Vt + 1e-12 * eye)
        cand = X - torch.cholesky_solve(gp[:, :, None], L)[:, :, 0]
        new = per_track(cand)
        better = new < costs
        X = torch.where(better[:, None], cand, X)
        costs = torch.where(better, new, costs)
    return start, float(costs.sum())


def refine(ext, intr, X, obs, free_slots, steps=2, tries=4):
    """The lowest cost that `steps` damped Gauss-Newton steps reach from the
    state, each step retried with 1000x the damping (at most `tries` times)
    while it raises the cost. Returns (cost at the state, lowest cost)."""
    obs_view, obs_group, obs_track, obs_uv = obs
    start = cost(residuals(ext, intr, X, obs_view, obs_group, obs_track, obs_uv))
    best = start
    for _ in range(steps):
        mu = 1e-9
        for _ in range(tries):
            cand = gauss_newton_step(ext, intr, X, obs, free_slots, mu)
            c = cost(residuals(*cand, obs_view, obs_group, obs_track, obs_uv))
            if c == c and c < best:
                ext, intr, X = cand
                best = c
                break
            mu *= 1e3
        else:
            break
    return start, best
