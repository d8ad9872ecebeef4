"""CQL — conservative Q-learning (offline RL).

Reference: rllib/algorithms/cql/ (cql.py, cql_torch_policy.py): SAC's
actor-critic updated purely from a fixed dataset, with the CQL(H) regularizer
pushing down Q on out-of-distribution actions (logsumexp over sampled
actions) and up on dataset actions. Reuses SAC's networks and squashed
policy; data comes from the offline readers (rllib/offline), never an env.

The tree lives on the config's device (the card by default) and one Adam
steps it, as in SAC. The draws (the policy noise at s', the uniform actions,
the policy noise of the penalty's actions and the actor's) come from a
``torch.Generator`` seeded with ``seed + 1`` on the device and enter the loss
as explicit tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.off_policy import (
    OffPolicyTraining,
    env_spaces,
    floats,
    frozen,
    mlp_apply,
    polyak,
    trainable,
)
from ray_tpu_torch.rllib.algorithms.sac.sac import (
    _squashed_sample,
    _take,
    init_sac_params,
    sac_params_from_jax,
)
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32, to_device
from ray_tpu_torch.rllib.core.rl_module import _device, tree_leaves, tree_map
from ray_tpu_torch.rllib.offline import make_input_reader
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    DONES,
    NEXT_OBS,
    OBS,
    REWARDS,
)


def cql_params_from_jax(params: dict, *, device="cuda") -> dict:
    """The reference's CQL params or targets (SAC's layout) as the port's
    tree on ``device``."""
    return sac_params_from_jax(params, device=device)


def cql_loss(params, target, batch, draws, *, discrete, action_dim, gamma, cql_alpha, n_cql, target_entropy):
    """(total loss, metrics) of one CQL batch of tensors. ``draws``
    (continuous only; the reference's ``k1``..``k4``): ``next`` [B, d]
    standard normals for the bootstrap's sample at s', ``rand`` [B, n, d]
    uniform actions in [-1, 1], ``pol`` [B n, d] standard normals for the
    penalty's policy actions (rows in ``repeat_interleave`` order), ``cur``
    [B, d] for the actor's sample at s."""
    obs, next_obs = batch[OBS], batch[NEXT_OBS]
    rewards, dones = batch[REWARDS], batch[DONES]
    alpha = torch.exp(params["log_alpha"]).detach()
    if discrete:
        # SAC-discrete backup + exact logsumexp penalty.
        next_logpi = F.log_softmax(mlp_apply(params["actor"], next_obs), dim=-1)
        next_pi = torch.exp(next_logpi)
        tq = torch.minimum(mlp_apply(target["q1"], next_obs), mlp_apply(target["q2"], next_obs))
        next_v = torch.sum(next_pi * (tq - alpha * next_logpi), dim=-1)
        td_target = (rewards + gamma * (1 - dones) * next_v).detach()
        q1_all = mlp_apply(params["q1"], obs)
        q2_all = mlp_apply(params["q2"], obs)
        q1, q2 = _take(q1_all, batch[ACTIONS]), _take(q2_all, batch[ACTIONS])
        bellman = 0.5 * (torch.mean((q1 - td_target) ** 2) + torch.mean((q2 - td_target) ** 2))
        cql_term = (
            torch.mean(torch.logsumexp(q1_all, dim=-1) - q1)
            + torch.mean(torch.logsumexp(q2_all, dim=-1) - q2)
        )
        logpi = F.log_softmax(mlp_apply(params["actor"], obs), dim=-1)
        pi = torch.exp(logpi)
        q_min = torch.minimum(q1_all, q2_all).detach()
        actor_loss = torch.mean(torch.sum(pi * (alpha * logpi - q_min), dim=-1))
        entropy = -torch.sum(pi * logpi, dim=-1).mean()
    else:
        next_a, next_logp, _ = _squashed_sample(params["actor"], next_obs, draws["next"], action_dim)
        tq1 = mlp_apply(target["q1"], torch.cat([next_obs, next_a], -1))[:, 0]
        tq2 = mlp_apply(target["q2"], torch.cat([next_obs, next_a], -1))[:, 0]
        td_target = (rewards + gamma * (1 - dones) * (torch.minimum(tq1, tq2) - alpha * next_logp)).detach()
        sa = torch.cat([obs, batch[ACTIONS]], -1)
        q1 = mlp_apply(params["q1"], sa)[:, 0]
        q2 = mlp_apply(params["q2"], sa)[:, 0]
        bellman = 0.5 * (torch.mean((q1 - td_target) ** 2) + torch.mean((q2 - td_target) ** 2))

        # CQL(H): logsumexp over uniform + policy actions with
        # importance weights (reference: cql_torch_policy.py).
        B = obs.shape[0]

        def q_of(qp, o, a):
            rep = torch.repeat_interleave(o, a.shape[1], dim=0)  # jnp.repeat(o, n, axis=0)
            flat = a.reshape(-1, action_dim)
            return mlp_apply(qp, torch.cat([rep, flat], -1))[:, 0].reshape(B, -1)

        rand_a = draws["rand"]
        pol_a, pol_logp, _ = _squashed_sample(
            params["actor"], torch.repeat_interleave(obs, n_cql, dim=0), draws["pol"], action_dim
        )
        # The conservative penalty must not train the actor: without
        # this stop_gradient, minimizing logsumexp Q(s, pi(s)) drives
        # the policy toward low-Q actions through pol_a (same shared-
        # optimizer leak class as the q_pi term below).
        pol_a = pol_a.detach().reshape(B, n_cql, action_dim)
        pol_logp = pol_logp.reshape(B, n_cql)
        log_u = -action_dim * math.log(2.0)  # uniform density on [-1,1]^d
        cql_term = 0.0
        for qp, qd in ((params["q1"], q1), (params["q2"], q2)):
            cat = torch.cat([q_of(qp, obs, rand_a) - log_u, q_of(qp, obs, pol_a) - pol_logp.detach()], dim=1)
            cql_term = cql_term + torch.mean(torch.logsumexp(cat, dim=1) - math.log(2.0 * n_cql) - qd)
        a_pi, logp_pi, _ = _squashed_sample(params["actor"], obs, draws["cur"], action_dim)
        # Stop-gradient the critics in the actor term: the shared
        # optimizer would otherwise push Q UP on policy actions,
        # directly fighting the CQL conservative penalty above.
        q_pi = torch.minimum(
            mlp_apply(frozen(params["q1"]), torch.cat([obs, a_pi], -1))[:, 0],
            mlp_apply(frozen(params["q2"]), torch.cat([obs, a_pi], -1))[:, 0],
        )
        actor_loss = torch.mean(alpha * logp_pi - q_pi)
        entropy = -logp_pi.mean()
    alpha_loss = params["log_alpha"] * (entropy - target_entropy).detach()
    total = bellman + cql_alpha * cql_term + actor_loss + alpha_loss
    return total, {
        "bellman_loss": bellman,
        "cql_term": cql_term,
        "actor_loss": actor_loss,
        "alpha": alpha,
    }


class CQLConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or CQL)
        self.lr = 3e-4
        self.num_rollout_workers = 0
        self.train_batch_size = 256
        self.tau = 5e-3
        self.initial_alpha = 1.0
        self.cql_alpha = 1.0  # conservative penalty weight
        self.num_cql_actions = 4  # sampled actions for the logsumexp
        self.updates_per_iter = 200
        self.input_: Optional[object] = None  # path / list / Dataset
        self.model_hiddens = (256, 256)

    def offline_data(self, *, input_=None, input_reader_kwargs=None) -> "CQLConfig":
        if input_ is not None:
            self.input_ = input_
        if input_reader_kwargs is not None:
            self.input_reader_kwargs = dict(input_reader_kwargs)
        return self

    def training(self, *, tau=None, initial_alpha=None, cql_alpha=None,
                 num_cql_actions=None, updates_per_iter=None, **kwargs) -> "CQLConfig":
        super().training(**kwargs)
        for name, val in (
            ("tau", tau), ("initial_alpha", initial_alpha), ("cql_alpha", cql_alpha),
            ("num_cql_actions", num_cql_actions), ("updates_per_iter", updates_per_iter),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class CQL(OffPolicyTraining, Algorithm):
    @classmethod
    def get_default_config(cls) -> CQLConfig:
        return CQLConfig(cls)

    def setup(self, config: dict) -> None:
        cfg: CQLConfig = self._algo_config
        self.device = _device(cfg.device)  # no card and no device="cpu": raise first
        assert cfg.input_ is not None, "CQL needs offline data: config.offline_data(input_=...)"
        # Dataset actions are in env units; the squashed policy and the CQL
        # logsumexp both live in [-1,1] — normalize at the data edge.
        self.discrete, self.obs_dim, self.action_dim, self._act_scale, self._act_offset = env_spaces(cfg)
        self.reader = make_input_reader(
            cfg.input_, gamma=cfg.gamma, seed=cfg.seed,
            **cfg.input_reader_kwargs,
        )
        params = init_sac_params(cfg.seed, self.obs_dim, self.action_dim, self.discrete, cfg.model_hiddens,
                                 device=self.device)
        params["log_alpha"] = torch.log(torch.tensor(cfg.initial_alpha, dtype=torch.float32, device=self.device))
        self.params = trainable(params, self.device)
        self.target = {k: tree_map(lambda t: t.detach().clone(), self.params[k]) for k in ("q1", "q2")}
        self.target_entropy = (
            0.98 * float(np.log(self.action_dim)) if self.discrete else -float(self.action_dim)
        )
        self.opt = OptaxChain(tree_leaves(self.params), cfg.lr)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._timesteps_total = 0

    def _update_draws(self, n: int) -> dict:
        """One update's draws (continuous; none when discrete)."""
        if self.discrete:
            return {}
        d, k, g, dev = self.action_dim, self._algo_config.num_cql_actions, self._gen, self.device
        return {"next": torch.randn((n, d), generator=g, device=dev),
                "rand": torch.rand((n, k, d), generator=g, device=dev) * 2.0 - 1.0,
                "pol": torch.randn((n * k, d), generator=g, device=dev),
                "cur": torch.randn((n, d), generator=g, device=dev)}

    def loss_and_grads(self, batch: dict, draws: dict):
        """(metrics, gradients in the tree's leaf order) of one batch of
        tensors on the device, in full f32."""
        cfg: CQLConfig = self._algo_config
        with full_f32(self.device):
            total, metrics = cql_loss(self.params, self.target, batch, draws, discrete=self.discrete,
                                      action_dim=self.action_dim, gamma=cfg.gamma, cql_alpha=cfg.cql_alpha,
                                      n_cql=cfg.num_cql_actions, target_entropy=self.target_entropy)
            grads = torch.autograd.grad(total, tree_leaves(self.params))
        return metrics, grads

    def update(self, batch: dict, draws: Optional[dict] = None) -> dict:
        """One CQL step from a batch of tensors on the device: one Adam step
        over the whole tree, then the Polyak targets toward the UPDATED
        critics. Returns the metrics as tensors on the device."""
        draws = self._update_draws(batch[OBS].shape[0]) if draws is None else draws
        metrics, grads = self.loss_and_grads(batch, draws)
        with full_f32(self.device):
            self.opt.step(grads)
        polyak(tree_leaves(self.target), tree_leaves({k: self.params[k] for k in ("q1", "q2")}),
               self._algo_config.tau)
        return {k: torch.as_tensor(v).detach() for k, v in metrics.items()}

    def read_batch(self, batch) -> dict:
        """A reader batch as the update's tensors on the device: continuous
        actions normalised to [-1, 1], a missing ``dones`` column zeros."""
        actions = np.asarray(batch[ACTIONS])
        if not self.discrete:
            actions = np.clip(
                (actions.reshape(len(actions), -1).astype(np.float32) - self._act_offset)
                / np.maximum(self._act_scale, 1e-8),
                -1.0,
                1.0,
            )
        cols = {
            OBS: np.asarray(batch[OBS], np.float32),
            ACTIONS: actions,
            REWARDS: np.asarray(batch[REWARDS], np.float32),
            DONES: np.asarray(batch.get(DONES, np.zeros(len(batch))), np.float32),
            NEXT_OBS: np.asarray(batch[NEXT_OBS], np.float32),
        }
        return to_device(cols, self.device)

    def training_step(self) -> dict:
        cfg: CQLConfig = self._algo_config
        last_m = None
        for _ in range(cfg.updates_per_iter):
            last_m = self.update(self.read_batch(self.reader.next(cfg.train_batch_size)))
            self._timesteps_total += cfg.train_batch_size
        return floats(last_m) if last_m is not None else {}

    @torch.no_grad()
    def compute_single_action(self, obs, explore: bool = False):
        x = torch.from_numpy(np.asarray(obs, np.float32).reshape(1, -1)).to(self.device)
        with full_f32(self.device):
            if self.discrete:
                return int(mlp_apply(self.params["actor"], x).argmax(-1)[0])
            eps = torch.randn((1, self.action_dim), generator=self._gen, device=self.device)
            a, _, det = _squashed_sample(self.params["actor"], x, eps, self.action_dim)
        return (a if explore else det).cpu().numpy()[0] * self._act_scale + self._act_offset
