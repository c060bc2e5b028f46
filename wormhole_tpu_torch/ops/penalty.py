"""Elastic-net proximal operator (reference learn/linear/penalty.h:36-41).

L1L2.Solve(-z, eta): w = soft-threshold solution of
    argmin_w  z·w + eta/2 w² + λ1|w| + λ2/2 w²
=>  w = sgn(-z) · max(|z| − λ1, 0) / (eta + λ2)
used by FTRL and the proximal SGD/AdaGrad handles.
"""

from __future__ import annotations

import torch


def l1l2_solve(neg_z, eta, lambda1: float, lambda2: float):
    """w minimizing z·w + (eta+λ2)/2 w² + λ1|w|, with neg_z = -z."""
    mag = torch.clamp(torch.abs(neg_z) - lambda1, min=0.0)
    return torch.sign(neg_z) * mag / (eta + lambda2)
