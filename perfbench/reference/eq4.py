"""The plain reference of the paper's block step, in float64 PyTorch.

Personalized P2P learning (Bellet et al., 2017, Eq. 2-4): agent i holds
theta_i, a weighted degree D_i = sum_j W_ij, a confidence c_i = m_i / max_j m_j
and the local loss L_i(theta) = (1 / m_i) sum_k l(theta; x_k, y_k) +
lambda_i |theta|^2 with lambda_i = 1 / m_i. The quadratic point loss is
l = (x . theta - y)^2. When agent i wakes it takes

    theta_i <- (1 - a_i) theta_i + a_i (sum_j W_ij theta_j / D_i - mu c_i (grad L_i(theta_i) + eta_i))

with a_i = 1 / (1 + mu c_i L_i^loc) and L_i^loc = 2 max |x|^2 + 2 lambda_i, the
point-loss smoothness bound over all the data, as the system computes its
step size. eta_i is 0 (Eq. 4) or Laplace noise (Eq. 6, privacy.py); with
a clip C each point gradient is scaled to an L1 norm of at most C. This
module computes the noise-free part; the comparison works out the noise
from it. A synchronous round applies the step to every agent from the
same snapshot.

Inputs are the benchmark's own host arrays (CSR graph, points, targets):
nothing here comes from the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


class Eq4Reference:
    """The Eq. 4 / Eq. 6 noise-free step over a CSR graph and padded data."""

    def __init__(self, indptr, indices, weights, X, y, mu: float, clip=None, delays=None,
                 device="cpu"):
        self.device = torch.device(device)
        self.indptr = torch.as_tensor(np.asarray(indptr), dtype=torch.int64, device=self.device)
        self.indices = torch.as_tensor(np.asarray(indices), dtype=torch.int64, device=self.device)
        self.weights = torch.as_tensor(np.asarray(weights), dtype=F64, device=self.device)
        self.delays = None if delays is None else torch.as_tensor(
            np.asarray(delays), dtype=torch.int64, device=self.device)
        self.X, self.y = X, y  # host numpy (n, m, p), (n, m)
        self.n, self.m, self.p = X.shape
        self.mu, self.clip = float(mu), clip
        rows = torch.repeat_interleave(torch.arange(self.n, device=self.device),
                                       self.indptr[1:] - self.indptr[:-1])
        self.deg = torch.zeros(self.n, dtype=F64, device=self.device).index_add_(
            0, rows, self.weights)
        self.counts = (self.indptr[1:] - self.indptr[:-1]).to(F64)
        m_i = torch.full((self.n,), float(self.m), dtype=F64, device=self.device)
        self.conf = torch.clamp(m_i / m_i.max(), 1e-3, 1.0)
        self.lam = 1.0 / m_i
        sq = 0.0
        for lo in range(0, self.n, 65536):
            xb = torch.as_tensor(X[lo:lo + 65536], device=self.device).to(F64)
            sq = max(sq, float((xb * xb).sum(-1).max()))
        self.alpha = 1.0 / (1.0 + self.mu * self.conf * (2.0 * sq + 2.0 * self.lam))

    def _edges(self, rows: torch.Tensor):
        """The CSR entries of ``rows``: (entry ids, position of the row in ``rows``)."""
        start, stop = self.indptr[rows], self.indptr[rows + 1]
        cnt = stop - start
        seg = torch.repeat_interleave(torch.arange(rows.numel(), device=self.device), cnt)
        first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        return torch.repeat_interleave(start, cnt) + torch.arange(seg.numel(),
                                                                   device=self.device) - first, seg

    def step(self, rows, thetas, dtype=F64, grad_noise=None) -> torch.Tensor:
        """The new rows (len(rows), p) of the agents ``rows``, computed in
        ``dtype`` (float64: the reference; a lower one: the control).
        ``thetas[d]`` is the (n, p) model matrix as of ``d`` slots before the
        slot (``thetas[0]`` its start); an edge with delay d reads its
        neighbour from ``thetas[d]``, the agent reads itself from
        ``thetas[0]``. ``grad_noise``: Eq. 6's (len(rows), p) eta, or None."""
        rows = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        e, seg = self._edges(rows)
        cols = self.indices[e]
        w = self.weights[e][:, None].to(dtype)
        neigh = torch.zeros((rows.numel(), self.p), dtype=dtype, device=self.device)
        lags = None if self.delays is None else self.delays[e]
        for lag, th in enumerate(thetas if lags is not None else thetas[:1]):
            sel = slice(None) if lags is None else torch.nonzero(lags == lag).squeeze(1)
            src = th[cols[sel].to(th.device)].to(self.device, dtype)
            neigh.index_add_(0, seg[sel], w[sel] * src)
        theta = thetas[0][rows.to(thetas[0].device)].to(self.device, dtype)
        host = rows.cpu().numpy()
        X = torch.as_tensor(self.X[host], device=self.device).to(dtype)
        y = torch.as_tensor(self.y[host], device=self.device).to(dtype)
        g = (2.0 * (torch.einsum("bmp,bp->bm", X, theta) - y))[..., None] * X
        if self.clip is not None:
            l1 = g.abs().sum(-1, keepdim=True)
            g = g * torch.clamp(self.clip / l1.clamp(min=1e-12), max=1.0)
        grad = g.sum(1) / self.m + 2.0 * self.lam[rows][:, None].to(dtype) * theta
        if grad_noise is not None:
            grad = grad + grad_noise.to(self.device, dtype)
        a = self.alpha[rows][:, None].to(dtype)
        c = self.conf[rows][:, None].to(dtype)
        deg = self.deg[rows][:, None].to(dtype)
        return (1.0 - a) * theta + a * (neigh / deg - self.mu * c * grad)

    def noise_coefficient(self, rows) -> torch.Tensor:
        """(len(rows),) factor a_i mu c_i by which Eq. 6 scales eta_i into the row."""
        rows = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        return self.alpha[rows] * self.mu * self.conf[rows]

    def round(self, theta, dtype=F64, block: int = 16384) -> torch.Tensor:
        """One synchronous round: every agent's step from ``theta``, (n, p)
        in ``dtype``, computed in blocks of rows."""
        out = torch.empty((self.n, self.p), dtype=dtype, device=self.device)
        for lo in range(0, self.n, block):
            rows = torch.arange(lo, min(lo + block, self.n), device=self.device)
            out[lo:lo + rows.numel()] = self.step(rows, [theta], dtype=dtype)
        return out
