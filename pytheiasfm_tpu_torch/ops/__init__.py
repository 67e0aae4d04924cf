"""Geometry kernels: rotations, polynomials, minimal solvers, epipolar
geometry and triangulation tests."""
