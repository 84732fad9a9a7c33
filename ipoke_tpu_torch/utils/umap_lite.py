"""UMAP in numpy for the latent scatter plots (the port's copy of
``ipoke_tpu/utils/umap_lite.py``; the reference logs UMAP embeddings of the
flow latents, its utils/logging.py:28-49 and second_stage_video.py:588-627).
``utils/logging.latent_scatter`` uses it where umap-learn is not installed.

The core of UMAP (McInnes et al., 2018) at the scale of that plot (a few
thousand points at most):

  1. the exact kNN graph (Euclidean);
  2. per point, (rho_i, sigma_i) such that the smoothed neighbour weights
     sum to log2(k): the fuzzy simplicial set;
  3. the probabilistic t-conorm  W = A + Aᵀ − A∘Aᵀ;
  4. a spectral initialisation from the symmetric normalised Laplacian;
  5. SGD over the edges with negative sampling on the (a, b) rational decay
     curve, with umap-learn's epochs_per_sample schedule.

No approximate kNN and no supervised mode.
"""
from __future__ import annotations

import numpy as np

# curve fit of 1/(1 + a d^{2b}) to the min_dist=0.1, spread=1.0 membership
# curve — umap-learn's defaults produce these constants
_A, _B = 1.576943, 0.895061


class UMAPLite:
    def __init__(self, n_neighbors=15, n_components=2, n_epochs=200,
                 min_dist=0.1, negative_sample_rate=5, seed=0):
        if n_components != 2:
            raise ValueError("UMAPLite supports n_components=2")
        self.k = n_neighbors
        self.n_epochs = n_epochs
        self.neg_rate = negative_sample_rate
        self.seed = seed

    # -- fuzzy simplicial set -------------------------------------------------
    @staticmethod
    def _knn(x, k):
        d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        idx = np.argsort(d2, axis=1)[:, :k]
        d = np.sqrt(np.take_along_axis(d2, idx, axis=1))
        return idx, d

    @staticmethod
    def _smooth_knn_dist(d, k, n_iter=64):
        """Binary-search sigma_i with target sum_j exp(-(d_ij-rho_i)/sigma_i)
        = log2(k); rho_i = nearest-neighbor distance."""
        target = np.log2(k)
        rho = d[:, 0]
        lo = np.zeros(len(d))
        hi = np.full(len(d), np.inf)
        sigma = np.ones(len(d))
        for _ in range(n_iter):
            psum = np.exp(-np.maximum(d - rho[:, None], 0.0) / sigma[:, None]).sum(1)
            too_big = psum > target
            hi = np.where(too_big, sigma, hi)
            lo = np.where(too_big, lo, sigma)
            sigma = np.where(
                np.isinf(hi), sigma * 2.0, (lo + hi) / 2.0
            )
        return rho, np.maximum(sigma, 1e-10)

    def _graph(self, x):
        n = len(x)
        idx, d = self._knn(x, self.k)
        rho, sigma = self._smooth_knn_dist(d, self.k)
        w = np.exp(-np.maximum(d - rho[:, None], 0.0) / sigma[:, None])
        a = np.zeros((n, n))
        rows = np.repeat(np.arange(n), self.k)
        a[rows, idx.ravel()] = w.ravel()
        return a + a.T - a * a.T  # probabilistic t-conorm

    # -- layout ---------------------------------------------------------------
    @staticmethod
    def _spectral_init(w):
        deg = w.sum(1)
        inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
        lap = np.eye(len(w)) - inv_sqrt[:, None] * w * inv_sqrt[None, :]
        try:
            vals, vecs = np.linalg.eigh(lap)
            emb = vecs[:, 1:3]  # skip the constant eigenvector
        except np.linalg.LinAlgError:
            emb = np.random.default_rng(0).standard_normal((len(w), 2))
        emb = emb / (np.abs(emb).max() + 1e-12) * 10.0
        return emb.astype(np.float64)

    def _optimize(self, emb, heads, tails, weights, rng):
        n = len(emb)
        eps = self.n_epochs
        epochs_per_sample = 1.0 / np.maximum(weights / weights.max(), 1e-12)
        next_sample = epochs_per_sample.copy()
        for epoch in range(eps):
            alpha = 1.0 - epoch / eps
            active = next_sample <= epoch + 1.0
            if not active.any():
                continue
            h, t = heads[active], tails[active]
            dy = emb[h] - emb[t]
            d2 = (dy * dy).sum(1)
            # attractive move along each sampled edge (coincident points get
            # zero gradient: 0**(b-1) diverges, umap-learn guards the same way)
            safe = np.maximum(d2, 1e-12)
            coeff = np.where(
                d2 > 0.0,
                (-2.0 * _A * _B * safe ** (_B - 1.0)) / (1.0 + _A * safe ** _B),
                0.0,
            )
            grad = np.clip(coeff[:, None] * dy, -4.0, 4.0) * alpha
            np.add.at(emb, h, grad)
            np.add.at(emb, t, -grad)
            # negative samples repel the head
            for _ in range(self.neg_rate):
                neg = rng.integers(0, n, size=len(h))
                dy = emb[h] - emb[neg]
                d2 = (dy * dy).sum(1)
                coeff = (2.0 * _B) / ((0.001 + d2) * (1.0 + _A * d2 ** _B))
                np.add.at(emb, h, np.clip(coeff[:, None] * dy, -4.0, 4.0) * alpha)
            next_sample[active] += epochs_per_sample[active]
        return emb

    def fit_transform(self, x):
        x = np.asarray(x, np.float64).reshape(len(x), -1)
        if len(x) <= self.k + 1:
            # degenerate tiny input: center & return first two coords
            c = x - x.mean(0)
            return c[:, :2] if c.shape[1] >= 2 else np.pad(c, ((0, 0), (0, 2 - c.shape[1])))
        w = self._graph(x)
        heads, tails = np.nonzero(np.triu(w) > 0)
        weights = w[heads, tails]
        emb = self._spectral_init(w)
        rng = np.random.default_rng(self.seed)
        return self._optimize(emb, heads, tails, weights, rng)
