"""Local differential privacy baseline (Supp. D.1).

Perturbs each data point itself before any learning: features get Laplace
noise calibrated to the feature-space L1 diameter, labels are flipped via
randomized response. The total per-point budget eps is split
``feature_frac`` / ``1 - feature_frac`` between the two. The perturbed
dataset is then (eps, 0)-locally-DP and can be released; purely local models
trained on it form the baseline of Fig. 4.

Port of ``repro.core.local_dp``: host-side numpy, the same draws from the
same ``rng``, so the perturbed arrays equal the reference's bit for bit.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.objective import AgentData


def perturb_dataset(
    data: AgentData,
    eps: float,
    rng: np.random.Generator,
    feature_bound: float | None = None,
    feature_frac: float = 0.8,
) -> AgentData:
    if eps <= 0:
        raise ValueError("eps must be positive")
    X, y, mask = data.X.copy(), data.y.copy(), data.mask.copy()
    eps_x = feature_frac * eps
    eps_y = (1.0 - feature_frac) * eps
    if feature_bound is None:
        feature_bound = float(np.abs(X[mask > 0]).max()) if mask.any() else 1.0
    # L1 sensitivity of the feature vector: replacing a point moves each
    # coordinate by at most 2B -> Delta_1 = 2 B p.
    p = X.shape[-1]
    delta1 = 2.0 * feature_bound * p
    X = X + rng.laplace(0.0, delta1 / eps_x, size=X.shape)
    # Randomized response on binary labels {-1, +1}.
    flip_prob = 1.0 / (1.0 + np.exp(min(eps_y, 50.0)))
    flips = rng.random(y.shape) < flip_prob
    y = np.where(flips, -y, y)
    X = X * mask[..., None]
    y = y * mask
    return AgentData(X=X, y=y, mask=mask)
