"""Geometry kernels: rotations, polynomials, minimal solvers, epipolar
geometry and triangulation tests. The minimal solvers: five-point, the 7/8-
point F, P3P and PnP (`p3p`, `pnp`, `known_rotation`), P4Pf / P5Pfr / P4Pfr
(`focal_radial`), the radial-distortion homography (`radial_homography`),
UPnP / MLPnP / gDLS (`generalized_pose`), the planar orthographic pose
(`orthographic`), the known-axis solvers (`partial_rotation`); SE(3) and
Sim(3) in `lie`."""

from . import (  # noqa: F401
    epipolar,
    five_point,
    focal_radial,
    generalized_pose,
    known_rotation,
    lie,
    orthographic,
    p3p,
    partial_rotation,
    pnp,
    polynomial,
    radial_homography,
    rotation,
    triangulation,
)
