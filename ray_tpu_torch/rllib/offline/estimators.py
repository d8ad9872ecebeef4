"""Off-policy estimators (OPE) — evaluate a target policy from logged data.

Reference: rllib/offline/estimators/ (off_policy_estimator.py,
importance_sampling.py, weighted_importance_sampling.py, direct_method.py,
doubly_robust.py): given behavior-policy episodes (SampleBatches carrying
``action_prob``), estimate the TARGET policy's value without running it:

- ``ImportanceSampling``  — per-episode product of likelihood ratios times
  the discounted return (unbiased, high variance);
- ``WeightedImportanceSampling`` — ratios self-normalized across episodes
  (biased, much lower variance);
- ``DirectMethod``        — fitted-Q evaluation: a Q-model trained on the
  logged transitions by TD under the target policy, evaluated at the
  episode starts;
- ``DoublyRobust``        — DM baseline plus importance-corrected TD
  residuals (unbiased if EITHER the ratios or the Q-model are right).

The target policy is anything exposing ``action_probs(obs_batch) ->
[B, A]`` (discrete); helpers adapt our Algorithm objects. The Q-model for
DM/DR is a small torch MLP (the reference's FQE model) trained with Adam as
optax computes it, on ``device``: the card unless the caller asks for the
CPU.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ray_tpu_torch.rllib.core.learner import OptaxChain
from ray_tpu_torch.rllib.core.rl_module import _device
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    DONES,
    EPS_ID,
    NEXT_OBS,
    OBS,
    REWARDS,
    SampleBatch,
)

ACTION_PROB = "action_prob"


def _split_episodes(batch: SampleBatch) -> list[dict]:
    """Split a flat batch into per-episode column dicts (EPS_ID order).
    One pass: a per-row full-mask scan would be O(episodes * rows)."""
    if len(batch) == 0:
        return []
    if EPS_ID not in batch and DONES not in batch:
        raise ValueError(
            "off-policy estimation needs either EPS_ID or DONES columns to "
            f"split episodes; batch has {sorted(batch.keys())}"
        )
    if EPS_ID in batch:
        ids = np.asarray(batch[EPS_ID])
        index_groups: dict = {}
        for i, eid in enumerate(ids.tolist()):
            index_groups.setdefault(eid, []).append(i)
        cols = {k: np.asarray(v) for k, v in batch.items()}
        return [
            {k: v[idx] for k, v in cols.items()}
            for idx in (np.asarray(g) for g in index_groups.values())
        ]
    # No episode ids: split on DONES.
    dones = np.asarray(batch[DONES]).astype(bool)
    bounds = np.flatnonzero(dones) + 1
    episodes = []
    start = 0
    for end in list(bounds) + ([len(dones)] if not dones[-1] else []):
        if end > start:
            episodes.append({k: np.asarray(v)[start:end] for k, v in batch.items()})
        start = end
    return episodes


def _ratios(policy, ep: dict) -> np.ndarray:
    """Per-step target/behavior likelihood ratios."""
    probs = np.asarray(policy.action_probs(np.asarray(ep[OBS], np.float32)))
    acts = np.asarray(ep[ACTIONS]).astype(int)
    target_p = probs[np.arange(len(acts)), acts]
    behavior_p = np.asarray(ep[ACTION_PROB], np.float64)
    return target_p / np.maximum(behavior_p, 1e-8)


def _discounted_return(rewards: np.ndarray, gamma: float) -> float:
    g = 0.0
    for r in reversed(np.asarray(rewards, np.float64)):
        g = r + gamma * g
    return float(g)


class OffPolicyEstimator:
    def __init__(self, policy, gamma: float = 0.99):
        self.policy = policy
        self.gamma = gamma

    def estimate(self, batch: SampleBatch) -> dict:
        raise NotImplementedError


class ImportanceSampling(OffPolicyEstimator):
    """Trajectory-wise IS (reference: importance_sampling.py)."""

    def estimate(self, batch: SampleBatch) -> dict:
        episodes = _split_episodes(batch)
        values, behavior = [], []
        for ep in episodes:
            rho = float(np.prod(_ratios(self.policy, ep)))
            g = _discounted_return(ep[REWARDS], self.gamma)
            values.append(rho * g)
            behavior.append(g)
        return {
            "v_target": float(np.mean(values)),
            "v_behavior": float(np.mean(behavior)),
            "num_episodes": len(values),
        }


class WeightedImportanceSampling(OffPolicyEstimator):
    """Self-normalized IS (reference: weighted_importance_sampling.py)."""

    def estimate(self, batch: SampleBatch) -> dict:
        weights, returns = [], []
        for ep in _split_episodes(batch):
            weights.append(float(np.prod(_ratios(self.policy, ep))))
            returns.append(_discounted_return(ep[REWARDS], self.gamma))
        weights = np.asarray(weights, np.float64)
        returns = np.asarray(returns, np.float64)
        denom = max(weights.sum(), 1e-8)
        return {
            "v_target": float((weights * returns).sum() / denom),
            "v_behavior": float(returns.mean()),
            "num_episodes": len(returns),
        }


def _mlp_params(gen, din, hiddens, dout):
    """Glorot-uniform dense layers with zero biases (the JAX package's
    ``sac._mlp_params``)."""
    layers = []
    for dout_i in list(hiddens) + [dout]:
        limit = float(np.sqrt(6.0 / (din + dout_i)))
        w = torch.rand(din, dout_i, generator=gen) * (2 * limit) - limit
        layers.append({"w": w, "b": torch.zeros(dout_i)})
        din = dout_i
    return layers


def fqe_params_from_jax(params) -> list:
    """The JAX package's FQE weights (``[{"w": [din, dout], "b": [dout]}, ...]``
    as numpy arrays) as the port's: the same layout, f32 tensors on the CPU."""
    return [{k: torch.tensor(np.asarray(layer[k], np.float32)) for k in ("w", "b")} for layer in params]


def _mlp_apply(layers, x):
    for layer in layers[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x @ layers[-1]["w"] + layers[-1]["b"]


class _FQEModel:
    """Minimal fitted-Q evaluation model: an MLP trained by TD under the
    TARGET policy (reference: fqe_torch_model.py)."""

    def __init__(self, obs_dim: int, n_actions: int, policy, gamma: float,
                 lr: float = 1e-3, hiddens=(64, 64), seed: int = 0, device="cuda"):
        self.device = _device(device)
        self.policy = policy
        self.gamma = gamma
        self.n_actions = n_actions
        gen = torch.Generator().manual_seed(seed)
        self.params = [{k: v.to(self.device).requires_grad_() for k, v in layer.items()}
                       for layer in _mlp_params(gen, obs_dim, tuple(hiddens), n_actions)]
        self.opt = OptaxChain([t for layer in self.params for t in (layer["b"], layer["w"])], lr)

    def _update(self, obs, acts, rew, dones, next_obs, next_pi):
        with torch.no_grad():
            q_next = _mlp_apply(self.params, next_obs)
            y = rew + self.gamma * (1.0 - dones) * torch.sum(next_pi * q_next, dim=-1)
        q_sa = _mlp_apply(self.params, obs).gather(1, acts[:, None].long())[:, 0]
        loss = torch.mean(torch.square(q_sa - y))
        self.opt.step(torch.autograd.grad(loss, self.opt.params))
        return loss.detach()

    def train(self, batch: SampleBatch, iterations: int = 200, batch_size: int = 256, seed: int = 0):
        rng = np.random.default_rng(seed)
        cols = (np.asarray(batch[OBS], np.float32), np.asarray(batch[ACTIONS]).astype(np.int64),
                np.asarray(batch[REWARDS], np.float32), np.asarray(batch[DONES], np.float32),
                np.asarray(batch[NEXT_OBS], np.float32))
        next_pi = np.asarray(self.policy.action_probs(cols[-1]), np.float32)
        cols = [torch.from_numpy(c).to(self.device) for c in cols + (next_pi,)]
        n = len(cols[0])
        loss = None
        for _ in range(iterations):
            idx = torch.from_numpy(rng.integers(0, n, min(batch_size, n))).to(self.device)
            loss = self._update(*(c[idx] for c in cols))
        return float(loss) if loss is not None else float("nan")

    def _q(self, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            x = torch.from_numpy(np.asarray(obs, np.float32)).to(self.device)
            return _mlp_apply(self.params, x).cpu().numpy()

    def v(self, obs: np.ndarray) -> np.ndarray:
        pi = np.asarray(self.policy.action_probs(obs))
        return (pi * self._q(obs)).sum(-1)

    def q(self, obs: np.ndarray, acts: np.ndarray) -> np.ndarray:
        return self._q(obs)[np.arange(len(acts)), np.asarray(acts).astype(int)]


def _episode_folds(episodes: list, n_splits: int):
    """Yield (train_batch, eval_episodes) per fold — the reference trains
    the FQE model on a DISJOINT split (k-fold) so the estimate is not
    optimistically biased by the model memorizing the evaluated rewards."""
    n_splits = max(1, min(n_splits, len(episodes)))
    folds = [episodes[i::n_splits] for i in range(n_splits)]
    for i, eval_eps in enumerate(folds):
        train_eps = [ep for j, fold in enumerate(folds) if j != i for ep in fold]
        if not train_eps:  # n_splits == 1: degenerate, train == eval
            train_eps = eval_eps
        train = SampleBatch({
            k: np.concatenate([ep[k] for ep in train_eps])
            for k in train_eps[0]
        })
        yield train, eval_eps


class DirectMethod(OffPolicyEstimator):
    """FQE value of the episode-start states, k-fold: each fold is scored
    by a Q-model trained on the OTHER folds (reference: direct_method.py +
    ope_utils train/test splits)."""

    def __init__(self, policy, gamma: float = 0.99, fqe_iterations: int = 300,
                 n_splits: int = 2, *, device="cuda"):
        super().__init__(policy, gamma)
        self.device = _device(device)
        self.fqe_iterations = fqe_iterations
        self.n_splits = n_splits
        self.model: _FQEModel | None = None  # last fold's model (introspection)

    def _fit_fold(self, train: SampleBatch, seed: int) -> "_FQEModel":
        obs = np.asarray(train[OBS], np.float32)
        n_actions = int(np.asarray(self.policy.action_probs(obs[:1])).shape[-1])
        model = _FQEModel(obs.shape[-1], n_actions, self.policy, self.gamma, seed=seed, device=self.device)
        model.train(train, iterations=self.fqe_iterations, seed=seed)
        self.model = model
        return model

    def _fold_values(self, model: "_FQEModel", eval_eps: list) -> list:
        starts = np.stack([ep[OBS][0] for ep in eval_eps])
        return list(model.v(starts))

    def estimate(self, batch: SampleBatch) -> dict:
        episodes = _split_episodes(batch)
        values: list = []
        for fold_i, (train, eval_eps) in enumerate(_episode_folds(episodes, self.n_splits)):
            model = self._fit_fold(train, seed=fold_i)
            values += self._fold_values(model, eval_eps)
        return {
            "v_target": float(np.mean(values)),
            "num_episodes": len(values),
        }


class DoublyRobust(DirectMethod):
    """DR = DM baseline + per-step importance-corrected TD residuals
    (reference: doubly_robust.py, Jiang & Li 2016); k-fold like DM."""

    def _fold_values(self, model: "_FQEModel", eval_eps: list) -> list:
        values = []
        for ep in eval_eps:
            obs = np.asarray(ep[OBS], np.float32)
            acts = np.asarray(ep[ACTIONS]).astype(int)
            rew = np.asarray(ep[REWARDS], np.float64)
            ratios = _ratios(self.policy, ep)
            v_hat = model.v(obs)
            q_hat = model.q(obs, acts)
            # Backward recursion: V_DR(t) = v(s) + rho_t (r + gamma V_DR(t+1) - q(s,a))
            v_dr = 0.0
            for t in reversed(range(len(obs))):
                v_dr = v_hat[t] + ratios[t] * (rew[t] + self.gamma * v_dr - q_hat[t])
            values.append(float(v_dr))
        return values


class AlgorithmPolicyAdapter:
    """Adapt a trained discrete Algorithm (DQN family etc.) or a logits fn
    to the ``action_probs`` protocol the estimators expect."""

    def __init__(self, probs_fn: Callable):
        self._fn = probs_fn

    def action_probs(self, obs_batch) -> np.ndarray:
        return np.asarray(self._fn(np.asarray(obs_batch, np.float32)))
