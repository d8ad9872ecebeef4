"""DDPG / TD3 — deterministic policy gradient for continuous control.

Reference: rllib/algorithms/ddpg/ (ddpg.py, ddpg_torch_policy.py) and
rllib/algorithms/td3/td3.py (TD3 = DDPG with twin critics, delayed policy
updates, and target-policy smoothing). One step updates the critics first,
then (on delayed steps) the actor against the UPDATED critics, plus
Polyak-averaged targets.

The parameters, targets and both Adam chains live on the config's device (the
card by default), in the JAX package's tree layout. The delay is decided on
the host (``_updates % policy_delay``): a skipped step leaves the actor, its
Adam moments and the targets untouched. The target-smoothing noise comes from
a ``torch.Generator`` seeded with ``seed + 1`` on the device and enters the
critic loss as an explicit tensor; the exploration noise, the random actions
before ``learning_starts`` and replay sampling are numpy, seeded as the
reference seeds them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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


def init_ddpg_params(seed, obs_dim, action_dim, hiddens, twin_q, *, device="cuda"):
    """The reference's shapes, Glorot-uniform draws from a torch generator
    seeded with ``seed`` on the CPU, then moved to ``device``."""
    gen = torch.Generator().manual_seed(int(seed))
    params = {
        "actor": mlp_params(gen, obs_dim, hiddens, action_dim),
        "q1": mlp_params(gen, obs_dim + action_dim, hiddens, 1),
    }
    if twin_q:
        params["q2"] = mlp_params(gen, obs_dim + action_dim, hiddens, 1)
    return tree_map(lambda t: t.to(_device(device)), params)


def ddpg_params_from_jax(params: dict, *, device="cuda") -> dict:
    """The reference's DDPG/TD3 params or targets (``actor``, ``q1`` and
    ``q2`` when twin) as the port's tree on ``device``."""
    return {k: mlp_params_from_jax(v, device=device) for k, v in params.items()}


def q_val(q, obs, a):
    return mlp_apply(q, torch.cat([obs, a], -1))[:, 0]


def ddpg_critic_loss(critic, target, batch, noise, *, gamma, twin_q, smooth, target_noise, noise_clip,
                     weights=None):
    """(critic loss, TD error of q1, mean q1). ``noise``: the standard-normal
    draws for TD3's target smoothing, shaped like the actions (None without
    smoothing). ``weights``: per-row importance weights (Ape-X)."""
    obs, next_obs = batch[OBS], batch[NEXT_OBS]
    next_a = torch.tanh(mlp_apply(target["actor"], next_obs))
    if smooth:
        eps = torch.clamp(noise * target_noise, -noise_clip, noise_clip)
        next_a = torch.clamp(next_a + eps, -1.0, 1.0)
    tq = q_val(target["q1"], next_obs, next_a)
    if twin_q:
        tq = torch.minimum(tq, q_val(target["q2"], next_obs, next_a))
    td_target = (batch[REWARDS] + gamma * (1 - batch[DONES]) * tq).detach()
    q1 = q_val(critic["q1"], obs, batch[ACTIONS])
    td_error = q1 - td_target
    if weights is None:
        loss = torch.mean(td_error ** 2)
    else:
        # Importance weights from the prioritized shards correct the
        # non-uniform sampling distribution (Ape-X keeps PER's IS step).
        loss = torch.mean(weights * td_error ** 2)
    if twin_q:
        q2 = q_val(critic["q2"], obs, batch[ACTIONS])
        loss = loss + (torch.mean((q2 - td_target) ** 2) if weights is None
                       else torch.mean(weights * (q2 - td_target) ** 2))
    return loss, td_error, q1.mean()


def ddpg_actor_loss(actor, critic, batch):
    obs = batch[OBS]
    a_pi = torch.tanh(mlp_apply(actor, obs))
    return -torch.mean(q_val(critic["q1"], obs, a_pi))


class DDPGConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DDPG)
        self.lr = 1e-3
        self.num_rollout_workers = 0
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.learning_starts = 1500
        self.tau = 5e-3
        self.rollout_steps_per_iter = 1000
        self.train_intensity = 1
        self.exploration_noise = 0.1  # gaussian action noise (in [-1,1] units)
        self.model_hiddens = (256, 256)
        # TD3 switches (reference: td3.py flips these on DDPGConfig):
        self.twin_q = False
        self.policy_delay = 1
        self.smooth_target_policy = False
        self.target_noise = 0.2
        self.target_noise_clip = 0.5

    def training(self, *, replay_buffer_capacity=None, learning_starts=None, tau=None,
                 rollout_steps_per_iter=None, train_intensity=None, exploration_noise=None,
                 twin_q=None, policy_delay=None, smooth_target_policy=None,
                 target_noise=None, target_noise_clip=None, **kwargs) -> "DDPGConfig":
        super().training(**kwargs)
        for name, val in (
            ("replay_buffer_capacity", replay_buffer_capacity),
            ("learning_starts", learning_starts),
            ("tau", tau),
            ("rollout_steps_per_iter", rollout_steps_per_iter),
            ("train_intensity", train_intensity),
            ("exploration_noise", exploration_noise),
            ("twin_q", twin_q),
            ("policy_delay", policy_delay),
            ("smooth_target_policy", smooth_target_policy),
            ("target_noise", target_noise),
            ("target_noise_clip", target_noise_clip),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class TD3Config(DDPGConfig):
    """TD3 defaults (reference: td3.py — twin critics, delayed actor,
    smoothed targets)."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or TD3)
        self.twin_q = True
        self.policy_delay = 2
        self.smooth_target_policy = True


class DDPG(OffPolicyTraining, Algorithm):
    @classmethod
    def get_default_config(cls) -> DDPGConfig:
        return DDPGConfig(cls)

    def setup(self, config: dict) -> None:
        self.cleanup()  # re-setup: close any previous env
        cfg: DDPGConfig = self._algo_config
        self._setup_learner(cfg)
        self.env = VectorEnv(cfg.env, max(cfg.num_envs_per_worker, 1), cfg.env_config, 0, seed=cfg.seed)
        self.buffer = ReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        self._np_rng = np.random.default_rng(cfg.seed)
        self._episode_reward_window: list = []

    def _setup_learner(self, cfg: DDPGConfig) -> None:
        """The learner's state on the config's device: the env's spaces, the
        weights, the targets, both Adam chains, the generator and the
        counters."""
        self.device = _device(cfg.device)  # no card and no device="cpu": raise first
        discrete, self.obs_dim, self.action_dim, self._act_scale, self._act_offset = env_spaces(cfg)
        assert not discrete, f"{type(self).__name__} needs continuous actions"
        self.params = trainable(init_ddpg_params(cfg.seed, self.obs_dim, self.action_dim, cfg.model_hiddens,
                                                 cfg.twin_q, device=self.device), self.device)
        self.target = tree_map(lambda t: t.detach().clone(), self.params)
        self._critic_keys = tuple(k for k in ("q1", "q2") if k in self.params)
        # Separate optimizers: the delayed (TD3) actor update must skip BOTH
        # the gradient and the Adam moment update — a zeroed gradient through
        # a shared optimizer would still move the actor via momentum.
        self.opt = {
            "actor": OptaxChain(tree_leaves(self.params["actor"]), cfg.lr),
            "critic": OptaxChain(tree_leaves(self._critic()), cfg.lr),
        }
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._timesteps_total = 0
        self._updates = 0

    def _critic(self) -> dict:
        return {k: self.params[k] for k in self._critic_keys}

    def _target_noise(self, n: int) -> Optional[torch.Tensor]:
        """TD3's target-smoothing draws for one update (None without
        smoothing)."""
        if not self._algo_config.smooth_target_policy:
            return None
        return torch.randn((n, self.action_dim), generator=self._gen, device=self.device)

    def train_step(self, batch, update_actor: bool, noise: Optional[torch.Tensor] = None) -> tuple:
        """One step (the reference's jitted ``train_step``): the critics'
        loss, gradients and Adam step; then, when ``update_actor``, the
        actor's loss through the UPDATED critics, its Adam step and the
        Polyak targets. A skipped step leaves the actor, its moments and the
        targets untouched. ``noise``: TD3's target-smoothing draws (by
        default ``_target_noise``'s; None there smooths nothing). A batch
        with a ``weights`` column (Ape-X's prioritized shards) weights each
        row's squared TD errors by it. Returns (the metrics, the TD errors of
        q1), tensors on the device."""
        cfg: DDPGConfig = self._algo_config
        tb = to_device(batch, self.device)
        noise = self._target_noise(tb[OBS].shape[0]) if noise is None else noise
        critic = self._critic()
        with full_f32(self.device):
            closs, td_error, mean_q = ddpg_critic_loss(
                critic, self.target, tb, noise, gamma=cfg.gamma, twin_q=cfg.twin_q,
                smooth=noise is not None, target_noise=cfg.target_noise, noise_clip=cfg.target_noise_clip,
                weights=tb.get("weights"))
            self.opt["critic"].step(torch.autograd.grad(closs, tree_leaves(critic)))
            if update_actor:
                aloss = ddpg_actor_loss(self.params["actor"], frozen(critic), tb)
                self.opt["actor"].step(torch.autograd.grad(aloss, tree_leaves(self.params["actor"])))
                polyak(tree_leaves(self.target), tree_leaves(self.params), cfg.tau)
            else:
                aloss = torch.zeros((), device=self.device)
        metrics = {"critic_loss": closs.detach(), "actor_loss": aloss.detach(), "mean_q": mean_q.detach()}
        return metrics, td_error.detach()

    @torch.no_grad()
    def _policy(self, obs: np.ndarray) -> np.ndarray:
        """The deterministic policy's actions in [-1, 1]: one forward on the
        device, the actions back in one read."""
        with full_f32(self.device):
            x = torch.from_numpy(np.require(obs, np.float32, "W")).to(self.device)
            return torch.tanh(mlp_apply(self.params["actor"], x)).cpu().numpy()

    def _env_action(self, a):
        return np.asarray(a) * self._act_scale + self._act_offset

    def training_step(self) -> dict:
        cfg: DDPGConfig = self._algo_config
        last_m = None
        for _ in range(cfg.rollout_steps_per_iter):
            obs = self.env.current_obs().astype(np.float32).reshape(self.env.num_envs, -1)
            if self._timesteps_total < cfg.learning_starts:
                a = self._np_rng.uniform(-1, 1, (self.env.num_envs, self.action_dim)).astype(np.float32)
            else:
                a = self._policy(obs)
                a = np.clip(a + self._np_rng.normal(0, cfg.exploration_noise, a.shape), -1, 1).astype(np.float32)
            _, rewards, dones, infos = self.env.step(self._env_action(a))
            next_obs, terminateds = true_transition(self.env, dones, infos)
            self.buffer.add(SampleBatch({
                OBS: obs, ACTIONS: a, REWARDS: rewards,
                DONES: terminateds, NEXT_OBS: next_obs,
            }))
            self._timesteps_total += self.env.num_envs
            if self._timesteps_total >= cfg.learning_starts:
                for _ in range(cfg.train_intensity):
                    batch = self.buffer.sample(cfg.train_batch_size)
                    self._updates += 1
                    last_m, _ = self.train_step(batch, self._updates % max(cfg.policy_delay, 1) == 0)
        stats_r, _ = self.env.pop_episode_stats()
        self._episode_reward_window += stats_r
        self._episode_reward_window = self._episode_reward_window[-100:]
        return floats(last_m) if last_m is not None else {}

    def compute_single_action(self, obs, explore: bool = False):
        a = self._policy(np.asarray(obs, np.float32).reshape(1, -1))[0]
        if explore:
            a = np.clip(a + self._np_rng.normal(0, self._algo_config.exploration_noise, a.shape), -1, 1)
        return self._env_action(a)


class TD3(DDPG):
    @classmethod
    def get_default_config(cls) -> TD3Config:
        return TD3Config(cls)
