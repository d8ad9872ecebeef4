"""Gaussian-process regression in numpy and scipy, for BayesOptSearch and PB2.

The JAX package fits scikit-learn's
``GaussianProcessRegressor(kernel=ConstantKernel(1.0) * Matern(nu=2.5),
alpha=...)`` (``tune/search/bayesopt.py``, ``tune/schedulers/pb2.py``); the
card's machine has no scikit-learn, so this module computes the same thing
with the same operations, in the same order:

- the kernel ``c * Matern_5/2(d / l)`` with θ = (log c, log l), both bounded
  to (1e-5, 1e5) and starting from θ = log(1, 1);
- one ``scipy.optimize.minimize(method="L-BFGS-B", jac=True)`` run on the
  negative log marginal likelihood and its gradient, no restarts; where that
  run stops early (L-BFGS-B's "ABNORMAL" line search), the θ it stopped at is
  kept, as scikit-learn keeps it;
- ``alpha`` added to the diagonal, a lower Cholesky factor, and
  ``predict(return_std=True)`` clipping a negative variance to 0.

Inputs are float64; ``y`` is used as given (no normalisation, the
regressor's default).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.linalg import cho_solve, cholesky, solve_triangular
from scipy.optimize import minimize
from scipy.spatial.distance import cdist, pdist, squareform

BOUNDS = (1e-5, 1e5)


def _matern52(dists):
    k = dists * math.sqrt(5)
    return (1.0 + k + k**2 / 3.0) * np.exp(-k)


def kernel(theta, X, Y=None, eval_gradient=False):
    """k(X, Y) = exp(θ0) * Matern_5/2(|x - y| / exp(θ1)); with
    ``eval_gradient`` (Y None) also dK/dθ, shape (n, n, 2)."""
    c, length_scale = np.exp(theta[0]), np.exp(theta[1])
    if Y is None:
        dists = pdist(X / length_scale, metric="euclidean")
        K2 = squareform(_matern52(dists))
        np.fill_diagonal(K2, 1)
        n_y = X.shape[0]
    else:
        K2 = _matern52(cdist(X / length_scale, Y / length_scale, metric="euclidean"))
        n_y = Y.shape[0]
    K1 = np.full((X.shape[0], n_y), c)
    if not eval_gradient:
        return K1 * K2
    D = squareform(dists**2)[:, :, np.newaxis]
    tmp = np.sqrt(5 * D)
    K2_gradient = 5.0 / 3.0 * D * (tmp + 1) * np.exp(-tmp)
    K1_gradient = np.full((X.shape[0], X.shape[0], 1), c)
    return K1 * K2, np.dstack((K1_gradient * K2[:, :, np.newaxis], K2_gradient * K1[:, :, np.newaxis]))


def log_marginal_likelihood(theta, X, y, alpha):
    """(log p(y | X, θ), its gradient in θ); (-inf, 0) where K + alpha I is
    not positive definite."""
    K, K_gradient = kernel(theta, X, eval_gradient=True)
    K[np.diag_indices_from(K)] += alpha
    try:
        L = cholesky(K, lower=True, check_finite=False)
    except np.linalg.LinAlgError:
        return -np.inf, np.zeros_like(theta)
    y_train = y[:, np.newaxis] if y.ndim == 1 else y
    a = cho_solve((L, True), y_train, check_finite=False)
    lml = -0.5 * np.einsum("ik,ik->k", y_train, a)
    lml -= np.log(np.diag(L)).sum()
    lml -= K.shape[0] / 2 * np.log(2 * np.pi)
    inner = np.einsum("ik,jk->ijk", a, a)
    K_inv = cho_solve((L, True), np.eye(K.shape[0]), check_finite=False)
    inner -= K_inv[..., np.newaxis]
    grad = 0.5 * np.einsum("ijl,jik->kl", inner, K_gradient)
    return lml.sum(axis=-1), grad.sum(axis=-1)


class GaussianProcess:
    """``fit(X, y)`` then ``predict(X)`` -> (mean, std)."""

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.theta = np.log(np.array([1.0, 1.0]))
        self.opt_result = None

    def fit(self, X, y) -> "GaussianProcess":
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64)
        bounds = np.log(np.vstack([BOUNDS, BOUNDS]))

        def objective(theta):
            lml, grad = log_marginal_likelihood(theta, X, y, self.alpha)
            return -lml, -grad

        self.opt_result = minimize(objective, self.theta, method="L-BFGS-B", jac=True, bounds=bounds)
        self.theta = self.opt_result.x
        K = kernel(self.theta, X)
        K[np.diag_indices_from(K)] += self.alpha
        self.L = cholesky(K, lower=True, check_finite=False)
        self.weights = cho_solve((self.L, True), y, check_finite=False)
        self.X = X
        return self

    def predict(self, X):
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        K_trans = kernel(self.theta, X, self.X)
        mean = K_trans @ self.weights
        V = solve_triangular(self.L, K_trans.T, lower=True, check_finite=False)
        var = np.full(X.shape[0], np.exp(self.theta[0]))
        var -= np.einsum("ij,ji->i", V.T, V)
        var[var < 0] = 0.0
        return mean, np.sqrt(var)
