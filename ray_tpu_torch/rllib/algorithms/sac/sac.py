"""SAC — soft actor-critic (continuous and discrete action spaces).

Reference: rllib/algorithms/sac/ (sac.py, sac_torch_policy.py,
sac_torch_model.py): off-policy replay, twin Q networks with Polyak-averaged
targets, tanh-squashed gaussian policy (continuous) or categorical policy with
exact expectations (discrete), and automatic entropy-temperature tuning.

The actor, the twin critics, the targets and ``log_alpha`` are one tree of
tensors in the JAX package's layout (a list of dense ``{"w": [din, dout],
"b"}`` per network, applied as ``x @ w + b``) on the config's device (the
card by default), stepped by ONE Adam over the whole tree, as the reference's
``optax.adam`` is: one backward of the summed critic, actor and alpha losses,
each ``stop_gradient`` a ``detach`` in the same place. The update and the
acting forward run in full f32 (``full_f32``).

Draws: the gaussian noise of the squashed policy comes from a
``torch.Generator`` seeded with ``seed + 1`` on the device, and the loss takes
it as explicit tensors (``draws``), so a caller can feed it any draws (the
reference's, rebuilt from its key). Random actions before ``learning_starts``
and replay sampling are numpy, seeded as the reference seeds them. Initial
weights are Glorot-uniform draws of the port's own (``sac_params_from_jax``
carries the reference's across).
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
    mlp_params,
    mlp_params_from_jax,
    polyak,
    trainable,
    true_transition,
)
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32, to_device
from ray_tpu_torch.rllib.core.rl_module import _device, tree_leaves, tree_map
from ray_tpu_torch.rllib.env.vector_env import VectorEnv
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    DONES,
    NEXT_OBS,
    OBS,
    REWARDS,
    SampleBatch,
)
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
LOG_2PI = math.log(2 * math.pi)


def sac_params_from_jax(params: dict, *, device="cuda") -> dict:
    """The reference's SAC params (``actor``, ``q1``, ``q2``, ``log_alpha``)
    or targets (``q1``, ``q2``) as the port's tree on ``device``."""
    dev = _device(device)
    return {k: (torch.tensor(np.asarray(v), dtype=torch.float32, device=dev) if k == "log_alpha"
                else mlp_params_from_jax(v, device=dev)) for k, v in params.items()}


def init_sac_params(seed, obs_dim, action_dim, discrete, hiddens, *, device="cuda"):
    """The reference's shapes, Glorot-uniform draws from a torch generator
    seeded with ``seed`` on the CPU (the card and the CPU start equal), then
    moved to ``device``."""
    gen = torch.Generator().manual_seed(int(seed))
    if discrete:
        actor = mlp_params(gen, obs_dim, hiddens, action_dim)
        q1 = mlp_params(gen, obs_dim, hiddens, action_dim)
        q2 = mlp_params(gen, obs_dim, hiddens, action_dim)
    else:
        actor = mlp_params(gen, obs_dim, hiddens, 2 * action_dim)
        q1 = mlp_params(gen, obs_dim + action_dim, hiddens, 1)
        q2 = mlp_params(gen, obs_dim + action_dim, hiddens, 1)
    params = {"actor": actor, "q1": q1, "q2": q2, "log_alpha": torch.zeros(())}
    return tree_map(lambda t: t.to(_device(device)), params)


def _squashed_sample(actor, obs, eps, action_dim):
    """tanh-squashed gaussian: sample with the standard-normal draws ``eps``
    (shaped like the mean), logp with the tanh jacobian term."""
    out = mlp_apply(actor, obs)
    mean, log_std = out[:, :action_dim], out[:, action_dim:]
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    std = torch.exp(log_std)
    u = mean + std * eps
    a = torch.tanh(u)
    logp = -0.5 * torch.sum(((u - mean) / std) ** 2 + 2 * log_std + LOG_2PI, dim=-1)
    logp = logp - torch.sum(2.0 * (math.log(2.0) - u - F.softplus(-2.0 * u)), dim=-1)
    return a, logp, torch.tanh(mean)


def _take(q, actions):
    return q.gather(1, actions.long()[:, None])[:, 0]


def sac_loss(params, target, batch, draws, *, discrete, action_dim, gamma, target_entropy):
    """(total loss, metrics) of one SAC batch of tensors. ``draws``: the
    continuous policy's standard-normal noise, ``{"next": [B, d]}`` for the
    bootstrap's sample at s' and ``{"cur": [B, d]}`` for the actor's at s
    (the reference's ``k1``, ``k2``); unused when ``discrete``."""
    obs, next_obs = batch[OBS], batch[NEXT_OBS]
    rewards, dones = batch[REWARDS], batch[DONES]
    alpha = torch.exp(params["log_alpha"]).detach()
    if discrete:
        logits = mlp_apply(params["actor"], obs)
        logpi = F.log_softmax(logits, dim=-1)
        pi = torch.exp(logpi)
        next_logits = mlp_apply(params["actor"], next_obs)
        next_logpi = F.log_softmax(next_logits, dim=-1)
        next_pi = torch.exp(next_logpi)
        tq = torch.minimum(mlp_apply(target["q1"], next_obs), mlp_apply(target["q2"], next_obs))
        next_v = torch.sum(next_pi * (tq - alpha * next_logpi), dim=-1)
        td_target = (rewards + gamma * (1 - dones) * next_v).detach()
        q1_all, q2_all = mlp_apply(params["q1"], obs), mlp_apply(params["q2"], obs)
        q1, q2 = _take(q1_all, batch[ACTIONS]), _take(q2_all, batch[ACTIONS])
        critic_loss = 0.5 * (torch.mean((q1 - td_target) ** 2) + torch.mean((q2 - td_target) ** 2))
        q_min = torch.minimum(q1_all, q2_all).detach()
        actor_loss = torch.mean(torch.sum(pi * (alpha * logpi - q_min), dim=-1))
        entropy = -torch.sum(pi * logpi, dim=-1).mean()
        alpha_loss = params["log_alpha"] * (entropy - target_entropy).detach()
    else:
        next_a, next_logp, _ = _squashed_sample(params["actor"], next_obs, draws["next"], action_dim)
        tq1 = mlp_apply(target["q1"], torch.cat([next_obs, next_a], -1))[:, 0]
        tq2 = mlp_apply(target["q2"], torch.cat([next_obs, next_a], -1))[:, 0]
        next_v = torch.minimum(tq1, tq2) - alpha * next_logp
        td_target = (rewards + gamma * (1 - dones) * next_v).detach()
        sa = torch.cat([obs, batch[ACTIONS]], -1)
        q1 = mlp_apply(params["q1"], sa)[:, 0]
        q2 = mlp_apply(params["q2"], sa)[:, 0]
        critic_loss = 0.5 * (torch.mean((q1 - td_target) ** 2) + torch.mean((q2 - td_target) ** 2))
        a, logp, _ = _squashed_sample(params["actor"], obs, draws["cur"], action_dim)
        # Critic params are stop-gradiented in the actor term: with a
        # single optimizer over the whole tree, -q_pi would otherwise
        # train q1/q2 to inflate Q on policy actions (the discrete
        # branch's q_min stop_gradient is the same guard).
        q_pi = torch.minimum(
            mlp_apply(frozen(params["q1"]), torch.cat([obs, a], -1))[:, 0],
            mlp_apply(frozen(params["q2"]), torch.cat([obs, a], -1))[:, 0],
        )
        actor_loss = torch.mean(alpha * logp - q_pi)
        entropy = -logp.mean()
        alpha_loss = params["log_alpha"] * (entropy - target_entropy).detach()
    total = critic_loss + actor_loss + alpha_loss
    return total, {
        "critic_loss": critic_loss,
        "actor_loss": actor_loss,
        "alpha": alpha,
        "entropy": entropy,
        "mean_q": q1.mean(),
    }


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SAC)
        self.lr = 3e-4
        self.num_rollout_workers = 0  # off-policy: collect in-process
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.learning_starts = 1500
        self.tau = 5e-3
        self.initial_alpha = 1.0
        self.target_entropy: Optional[float] = None  # None -> auto
        self.rollout_steps_per_iter = 1000
        self.train_intensity = 1  # gradient steps per env step
        self.model_hiddens = (256, 256)

    def training(self, *, replay_buffer_capacity=None, learning_starts=None,
                 tau=None, initial_alpha=None, target_entropy=None,
                 rollout_steps_per_iter=None, train_intensity=None, **kwargs) -> "SACConfig":
        super().training(**kwargs)
        for name, val in (
            ("replay_buffer_capacity", replay_buffer_capacity),
            ("learning_starts", learning_starts),
            ("tau", tau),
            ("initial_alpha", initial_alpha),
            ("target_entropy", target_entropy),
            ("rollout_steps_per_iter", rollout_steps_per_iter),
            ("train_intensity", train_intensity),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class SAC(OffPolicyTraining, Algorithm):
    @classmethod
    def get_default_config(cls) -> SACConfig:
        return SACConfig(cls)

    def setup(self, config: dict) -> None:
        self.cleanup()  # re-setup: close any previous env
        cfg: SACConfig = self._algo_config
        self.device = _device(cfg.device)  # no card and no device="cpu": raise first
        self.discrete, self.obs_dim, self.action_dim, self._act_scale, self._act_offset = env_spaces(cfg)
        self.env = VectorEnv(cfg.env, max(cfg.num_envs_per_worker, 1), cfg.env_config, 0, seed=cfg.seed)
        params = init_sac_params(cfg.seed, self.obs_dim, self.action_dim, self.discrete, cfg.model_hiddens,
                                 device=self.device)
        params["log_alpha"] = torch.log(torch.tensor(cfg.initial_alpha, dtype=torch.float32, device=self.device))
        self.params = trainable(params, self.device)
        self.target = {k: tree_map(lambda t: t.detach().clone(), self.params[k]) for k in ("q1", "q2")}
        if cfg.target_entropy is not None:
            self.target_entropy = float(cfg.target_entropy)
        elif self.discrete:
            self.target_entropy = 0.98 * float(np.log(self.action_dim))
        else:
            self.target_entropy = -float(self.action_dim)
        self.opt = OptaxChain(tree_leaves(self.params), cfg.lr)
        self.buffer = ReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._np_rng = np.random.default_rng(cfg.seed)
        self._timesteps_total = 0
        self._episode_reward_window: list = []

    # -- draws ------------------------------------------------------------------
    def _act_draws(self, n: int) -> torch.Tensor:
        """The acting forward's draws for ``n`` rows: standard normals
        (continuous), or uniforms for the gumbel-max categorical (discrete)."""
        if self.discrete:
            return torch.rand((n, self.action_dim), generator=self._gen, device=self.device)
        return torch.randn((n, self.action_dim), generator=self._gen, device=self.device)

    def _update_draws(self, n: int) -> dict:
        """One update's draws: the policy noise at s' and at s."""
        if self.discrete:
            return {}
        return {k: torch.randn((n, self.action_dim), generator=self._gen, device=self.device)
                for k in ("next", "cur")}

    # -- the update -------------------------------------------------------------
    def loss_and_grads(self, batch: dict, draws: dict):
        """(metrics, gradients in the tree's leaf order) of one batch of
        tensors on the device, in full f32."""
        cfg: SACConfig = self._algo_config
        with full_f32(self.device):
            total, metrics = sac_loss(self.params, self.target, batch, draws, discrete=self.discrete,
                                      action_dim=self.action_dim, gamma=cfg.gamma,
                                      target_entropy=self.target_entropy)
            grads = torch.autograd.grad(total, tree_leaves(self.params))
        return metrics, grads

    def update(self, batch, draws: Optional[dict] = None) -> dict:
        """One SAC step (the reference's jitted ``train_step``): the summed
        loss's gradients, one Adam step over the whole tree, then the Polyak
        targets toward the UPDATED critics. Returns the metrics as tensors on
        the device (no host sync)."""
        tb = to_device(batch, self.device)
        draws = self._update_draws(tb[OBS].shape[0]) if draws is None else draws
        metrics, grads = self.loss_and_grads(tb, draws)
        with full_f32(self.device):
            self.opt.step(grads)
        polyak(tree_leaves(self.target), tree_leaves({k: self.params[k] for k in ("q1", "q2")}),
               self._algo_config.tau)
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def _act(self, obs: np.ndarray, explore: bool) -> np.ndarray:
        """One forward on the device for a host batch of observations; the
        actions come back in one read."""
        x = torch.from_numpy(np.require(obs, np.float32, "W")).to(self.device)
        draws = self._act_draws(x.shape[0])
        with full_f32(self.device):
            if self.discrete:
                logits = mlp_apply(self.params["actor"], x)
                if explore:
                    # jax.random.categorical's gumbel-max, on the port's draws.
                    logits = logits - torch.log(-torch.log(draws.clamp_min(torch.finfo(torch.float32).tiny)))
                return logits.argmax(-1).cpu().numpy()
            a, _, det = _squashed_sample(self.params["actor"], x, draws, self.action_dim)
        return (a if explore else det).cpu().numpy()

    def _env_action(self, a):
        if self.discrete:
            return np.asarray(a)
        return np.asarray(a) * self._act_scale + self._act_offset

    def training_step(self) -> dict:
        cfg: SACConfig = self._algo_config
        last_m = None
        for _ in range(cfg.rollout_steps_per_iter):
            obs = self.env.current_obs().astype(np.float32).reshape(self.env.num_envs, -1)
            if self._timesteps_total < cfg.learning_starts:
                if self.discrete:
                    a = self._np_rng.integers(0, self.action_dim, self.env.num_envs)
                else:
                    a = self._np_rng.uniform(-1, 1, (self.env.num_envs, self.action_dim)).astype(np.float32)
            else:
                a = self._act(obs, True)
            _, rewards, dones, infos = self.env.step(self._env_action(a))
            next_obs, terminateds = true_transition(self.env, dones, infos)
            self.buffer.add(SampleBatch({
                OBS: obs, ACTIONS: a, REWARDS: rewards,
                DONES: terminateds, NEXT_OBS: next_obs,
            }))
            self._timesteps_total += self.env.num_envs
            if self._timesteps_total >= cfg.learning_starts:
                for _ in range(cfg.train_intensity):
                    last_m = self.update(self.buffer.sample(cfg.train_batch_size))
        stats_r, _ = self.env.pop_episode_stats()
        self._episode_reward_window += stats_r
        self._episode_reward_window = self._episode_reward_window[-100:]
        return floats(last_m) if last_m is not None else {}

    def compute_single_action(self, obs, explore: bool = False):
        a = self._act(np.asarray(obs, np.float32).reshape(1, -1), explore)[0]
        if self.discrete:
            return int(a)
        return self._env_action(a)
