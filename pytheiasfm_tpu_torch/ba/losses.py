"""Robust loss functions for bundle adjustment (IRLS weights).

Counterpart of the JAX package's `ba/losses.py` (`theia::LossFunctionType` +
`CreateLossFunction`, `create_loss_function.{h,cc}`): TRIVIAL, HUBER,
SOFTLONE, CAUCHY, ARCTAN, TUKEY, the Ceres loss family.

Each loss is expressed through rho(s) on the SQUARED residual norm s and its
IRLS weight w(s) = rho'(s); a solver multiplies each observation's
residual/Jacobian by sqrt(w), which is Ceres' corrector to first order.
"""

from __future__ import annotations

import enum

import torch

__all__ = ["LossFunctionType", "loss_rho", "loss_weight"]


class LossFunctionType(enum.IntEnum):
    """Parity: `theia::LossFunctionType` (`create_loss_function.h`)."""

    TRIVIAL = 0
    HUBER = 1
    SOFTLONE = 2
    CAUCHY = 3
    ARCTAN = 4
    TUKEY = 5


def loss_rho(s, loss: LossFunctionType, scale: float):
    """rho(s) for squared residual s (Ceres conventions)."""
    a2 = scale * scale
    if loss == LossFunctionType.TRIVIAL:
        return s
    if loss == LossFunctionType.HUBER:
        r = torch.sqrt(torch.clamp(s, min=0.0))
        return torch.where(s <= a2, s, 2.0 * scale * r - a2)
    if loss == LossFunctionType.SOFTLONE:
        return 2.0 * a2 * (torch.sqrt(1.0 + s / a2) - 1.0)
    if loss == LossFunctionType.CAUCHY:
        return a2 * torch.log1p(s / a2)
    if loss == LossFunctionType.ARCTAN:
        return scale * torch.atan2(s, torch.full_like(s, scale))
    if loss == LossFunctionType.TUKEY:
        u = torch.clamp(s / a2, max=1.0)
        return a2 / 3.0 * (1.0 - (1.0 - u) ** 3)
    raise ValueError(f"unknown loss {loss}")


def loss_weight(s, loss: LossFunctionType, scale: float):
    """IRLS weight w = rho'(s); w == 1 for the trivial loss."""
    a2 = scale * scale
    if loss == LossFunctionType.TRIVIAL:
        return torch.ones_like(s)
    if loss == LossFunctionType.HUBER:
        r = torch.sqrt(torch.clamp(s, min=1e-30))
        return torch.where(s <= a2, torch.ones_like(s), scale / r)
    if loss == LossFunctionType.SOFTLONE:
        return 1.0 / torch.sqrt(1.0 + s / a2)
    if loss == LossFunctionType.CAUCHY:
        return 1.0 / (1.0 + s / a2)
    if loss == LossFunctionType.ARCTAN:
        return scale * scale / (scale * scale + s * s)
    if loss == LossFunctionType.TUKEY:
        u = s / a2
        return torch.where(u <= 1.0, (1.0 - u) ** 2, torch.zeros_like(s))
    raise ValueError(f"unknown loss {loss}")
