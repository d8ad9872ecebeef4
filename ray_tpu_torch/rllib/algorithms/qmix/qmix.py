"""QMIX — monotonic value factorization for cooperative multi-agent RL.

Reference: rllib/algorithms/qmix/{qmix.py,qmix_policy.py} (Rashid et al.
2018): per-agent Q networks (weights shared across agents) produce Q_a(o_a);
a mixing network whose non-negative weights are generated by hypernetworks
conditioned on the GLOBAL state combines them into Q_tot, trained with 1-step
TD against a target copy of both nets. Monotonicity (dQ_tot/dQ_a >= 0) makes
the argmax of each agent's local Q consistent with the joint argmax, so
decentralized greedy execution optimizes the centralized objective.

The train step and the acting forward run on the config's device (the card
unless it asks for the CPU); the env, the epsilon draws and the replay stay
on the host, numpy-seeded as the reference seeds them. The weights are drawn
as the reference draws them (``normal * sqrt(2 / fan_in)``, zero biases) but
from a CPU ``torch.Generator``, so the port's initial weights are its own
(``qmix_params_from_jax`` carries the reference's across). The MLPs apply
``maximum(x, 0)``, the mixer ``where(h > 0, h, exp(min(h, 0)) - 1)`` and
``where(x >= 0, x, -x)`` for ``|x|``: the reference's own forms, and their
derivatives at 0 (``jnp.maximum``'s 1/2, ``jnp.abs``'s +1) are the
reference's too.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.off_policy import floats, mlp_params_from_jax
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32
from ray_tpu_torch.rllib.core.rl_module import _device, copy_into, host_tree, tree_leaves, tree_map
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv

HEADS = ("agent", "hyper_w1", "hyper_b1", "hyper_w2", "hyper_b2")


def _mlp_init(gen, sizes):
    """``w`` drawn ``normal * sqrt(2 / a)`` ([a, b]), ``b`` zeros."""
    return [{"w": torch.randn(a, b, generator=gen) * math.sqrt(2.0 / a), "b": torch.zeros(b)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _mlp_apply(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.maximum(x, torch.zeros_like(x))
    return x


def _abs(x):
    """``jnp.abs`` with its derivative: +1 at 0 (``select(x >= 0, g, -g)``),
    where ``torch.abs``'s is 0."""
    return torch.where(x >= 0, x, -x)


def mixer(params, agent_qs, state):
    """Monotonic mixer: Q_tot = w2(s) . elu(w1(s) Q + b1(s)) + b2(s), with
    |.| on the hypernet outputs enforcing dQ_tot/dQ_a >= 0."""
    B, A = agent_qs.shape
    w1 = _abs(_mlp_apply(params["hyper_w1"], state)).reshape(B, A, -1)   # [B,A,E]
    b1 = _mlp_apply(params["hyper_b1"], state)                           # [B,E]
    h = torch.einsum("ba,bae->be", agent_qs, w1) + b1
    h = torch.where(h > 0, h, torch.exp(torch.minimum(h, torch.zeros_like(h))) - 1.0)  # elu
    w2 = _abs(_mlp_apply(params["hyper_w2"], state))                     # [B,E]
    b2 = _mlp_apply(params["hyper_b2"], state)                           # [B,1]
    return torch.einsum("be,be->b", h, w2) + b2[:, 0]


def qmix_loss(params, target, batch, *, gamma):
    """(mean squared TD error, metrics) of one batch of tensors (``obs`` and
    ``next_obs`` [B, A, obs_dim], ``state`` and ``next_state`` [B,
    state_dim], ``actions`` [B, A], ``rewards`` and ``dones`` [B])."""
    obs, next_obs = batch["obs"], batch["next_obs"]
    state, next_state = batch["state"], batch["next_state"]
    actions = batch["actions"].long()
    rewards, dones = batch["rewards"], batch["dones"]
    B, A = actions.shape

    q = _mlp_apply(params["agent"], obs.reshape(B * A, -1)).reshape(B, A, -1)
    q_taken = torch.gather(q, -1, actions[..., None])[..., 0]
    q_tot = mixer(params, q_taken, state)

    with torch.no_grad():
        tq = _mlp_apply(target["agent"], next_obs.reshape(B * A, -1)).reshape(B, A, -1)
        q_tot_next = mixer(target, tq.max(dim=-1).values, next_state)
        y = rewards + gamma * (1.0 - dones) * q_tot_next
    td = q_tot - y
    return torch.mean(torch.square(td)), {"td_abs": torch.abs(td).mean(), "q_tot": q_tot.mean()}


def qmix_params_from_jax(params: dict, *, device="cuda") -> dict:
    """The reference's QMIX params or target (``agent`` and the four
    hypernets, each a list of ``{"w": [a, b], "b": [b]}``) as the port's tree
    on ``device``."""
    return {k: mlp_params_from_jax(params[k], device=device) for k in HEADS}


class QMIXConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or QMIX)
        self.lr = 5e-4
        self.mixing_embed_dim = 32
        self.hidden_dim = 64
        self.replay_buffer_capacity = 5000
        self.learning_starts = 200
        self.train_batch_size = 32
        self.target_network_update_freq = 100
        self.rollout_steps_per_iter = 200
        self.train_intensity = 2  # env steps per learner update
        self.epsilon_timesteps = 4000
        self.initial_epsilon = 1.0
        self.final_epsilon = 0.05

    def training(self, *, mixing_embed_dim=None, hidden_dim=None,
                 replay_buffer_capacity=None, learning_starts=None,
                 target_network_update_freq=None, rollout_steps_per_iter=None,
                 train_intensity=None, epsilon_timesteps=None,
                 final_epsilon=None, **kwargs) -> "QMIXConfig":
        super().training(**kwargs)
        for name, val in (
            ("mixing_embed_dim", mixing_embed_dim),
            ("hidden_dim", hidden_dim),
            ("replay_buffer_capacity", replay_buffer_capacity),
            ("learning_starts", learning_starts),
            ("target_network_update_freq", target_network_update_freq),
            ("rollout_steps_per_iter", rollout_steps_per_iter),
            ("train_intensity", train_intensity),
            ("epsilon_timesteps", epsilon_timesteps),
            ("final_epsilon", final_epsilon),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class QMIX(Algorithm):
    @classmethod
    def get_default_config(cls) -> QMIXConfig:
        return QMIXConfig(cls)

    def setup(self, config: dict) -> None:
        cfg: QMIXConfig = self._algo_config
        self.device = _device(cfg.device)  # no card and no device="cpu": raise before the env
        # Re-setup must not leak the previous env's resources.
        old_env = getattr(self, "env", None)
        if old_env is not None:
            old_env.close()
        env = cfg.env(dict(cfg.env_config)) if callable(cfg.env) else cfg.env
        assert isinstance(env, MultiAgentEnv), "QMIX requires a MultiAgentEnv"
        self.env = env
        self.agents = list(env.possible_agents)
        self.n_agents = len(self.agents)
        self.obs_dim = int(np.prod(env.observation_space.shape))
        self.n_actions = int(env.action_space.n)
        self.state_dim = (
            int(np.prod(env.state_space.shape))
            if hasattr(env, "state_space")
            else self.obs_dim * self.n_agents
        )

        gen = torch.Generator().manual_seed(int(cfg.seed))
        E, Hd = cfg.mixing_embed_dim, cfg.hidden_dim
        sizes = {
            "agent": (self.obs_dim, Hd, Hd, self.n_actions),
            "hyper_w1": (self.state_dim, Hd, self.n_agents * E),
            "hyper_b1": (self.state_dim, E),
            "hyper_w2": (self.state_dim, Hd, E),
            "hyper_b2": (self.state_dim, E, 1),
        }
        init = {k: _mlp_init(gen, sizes[k]) for k in HEADS}
        self.params = tree_map(lambda t: t.to(self.device).requires_grad_(True), init)
        self.target = tree_map(lambda t: t.detach().clone(), self.params)
        self.opt = OptaxChain(tree_leaves(self.params), cfg.lr)

        from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer

        self.buffer = ReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        self._rng = np.random.default_rng(cfg.seed)
        self._timesteps_total = 0
        self._updates = 0
        self._episode_reward_window: list = []
        self._obs_dict, _ = env.reset(seed=cfg.seed)
        self._episode_reward = 0.0

    def _global_state(self, obs_dict) -> np.ndarray:
        if hasattr(self.env, "state"):
            return np.asarray(self.env.state(), np.float32).ravel()
        return np.concatenate(
            [np.asarray(obs_dict[a], np.float32).ravel() for a in self.agents]
        )

    def _epsilon(self) -> float:
        cfg = self._algo_config
        frac = min(1.0, self._timesteps_total / max(cfg.epsilon_timesteps, 1))
        return cfg.initial_epsilon + frac * (cfg.final_epsilon - cfg.initial_epsilon)

    @torch.no_grad()
    def _q_values(self, obs_stack: np.ndarray) -> np.ndarray:
        """Every agent's Q values ([A, obs_dim] -> [A, n_actions]): one
        forward on the device, one read."""
        x = torch.from_numpy(np.require(obs_stack, np.float32, "W")).to(self.device)
        with full_f32(self.device):
            return _mlp_apply(self.params["agent"], x).cpu().numpy()

    def train_step(self, batch: dict) -> dict:
        """One TD step of the agent network and the hypernets (the
        reference's jitted ``train_step``): the loss on the device in full
        f32, Adam. Returns the metrics as tensors on the device."""
        tb = {k: torch.from_numpy(np.require(np.asarray(v), requirements="W")).to(self.device)
              for k, v in batch.items()}
        with full_f32(self.device):
            loss, aux = qmix_loss(self.params, self.target, tb, gamma=self._algo_config.gamma)
            grads = torch.autograd.grad(loss, self.opt.params)
            self.opt.step(grads)
        return {k: v.detach() for k, v in aux.items()}

    def training_step(self) -> dict:
        from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

        cfg: QMIXConfig = self._algo_config
        metrics: dict = {}
        last_aux = None
        for _ in range(cfg.rollout_steps_per_iter):
            obs_stack = np.stack(
                [np.asarray(self._obs_dict[a], np.float32).ravel() for a in self.agents]
            )  # [A, obs_dim]
            state = self._global_state(self._obs_dict)
            q = self._q_values(obs_stack)  # [A, n_act]
            acts = q.argmax(axis=-1)
            mask = self._rng.random(self.n_agents) < self._epsilon()
            acts = np.where(mask, self._rng.integers(0, self.n_actions, self.n_agents), acts)
            action_dict = {a: int(acts[i]) for i, a in enumerate(self.agents)}
            next_obs, rewards, terms, truncs, _ = self.env.step(action_dict)
            terminated = bool(
                terms.get("__all__", all(terms.get(a, False) for a in self.agents))
            )
            truncated = bool(truncs.get("__all__", False))
            done = terminated or truncated
            # Team reward: cooperative setting sums the per-agent rewards.
            r = float(sum(rewards.values()))
            self._episode_reward += r
            next_state = self._global_state(next_obs)
            self.buffer.add(SampleBatch({
                "obs": obs_stack[None],
                "next_obs": np.stack(
                    [np.asarray(next_obs[a], np.float32).ravel() for a in self.agents]
                )[None],
                "state": state[None],
                "next_state": next_state[None],
                "actions": acts[None],
                "rewards": np.asarray([r], np.float32),
                # TD bootstrapping is masked only on TRUE termination: a
                # time-limit truncation is not a terminal state, so its
                # target keeps gamma * Q_tot(next) (gymnasium semantics).
                "dones": np.asarray([float(terminated)], np.float32),
            }))
            self._timesteps_total += 1
            if done:
                self._episode_reward_window.append(self._episode_reward)
                self._episode_reward_window = self._episode_reward_window[-100:]
                self._episode_reward = 0.0
                self._obs_dict, _ = self.env.reset()
            else:
                self._obs_dict = next_obs
            if (
                len(self.buffer) >= cfg.learning_starts
                and self._timesteps_total % max(cfg.train_intensity, 1) == 0
            ):
                last_aux = self.train_step(self.buffer.sample(cfg.train_batch_size))
                self._updates += 1
                if self._updates % cfg.target_network_update_freq == 0:
                    copy_into(self.target, self.params)
        if last_aux is not None:
            metrics = floats(last_aux)  # ONE device sync per iteration
        metrics["epsilon"] = self._epsilon()
        return metrics

    def step(self) -> dict:
        t0 = time.time()
        result = self.training_step()
        result["episode_reward_mean"] = (
            float(np.mean(self._episode_reward_window))
            if self._episode_reward_window
            else float("nan")
        )
        result["timesteps_total"] = self._timesteps_total
        result["time_this_iter_s"] = time.time() - t0
        return result

    def _evaluate_local(self, duration: int, by_episodes: bool):
        """Greedy (epsilon-free) team episodes; overrides the base
        single-agent eval loop — QMIX envs take action DICTS and the team
        reward is the per-agent sum."""
        cfg = self._algo_config
        shared = not callable(cfg.env)
        # Fresh env per round (closed below); instance-config borrows the
        # training env since a second instance can't be constructed.
        env = self.env if shared else cfg.env(dict(cfg.env_config))
        rewards, lens, steps = [], [], 0
        try:
            for _ in range(duration if by_episodes else 64):
                obs_d, _ = env.reset()
                total, length = 0.0, 0
                for _ in range(10_000):
                    obs_d, rew_d, term_d, trunc_d, _ = env.step(self.compute_actions(obs_d))
                    total += float(sum(rew_d.get(a, 0.0) for a in self.agents))
                    length += 1
                    steps += 1
                    done = bool(
                        term_d.get("__all__", all(term_d.get(a, False) for a in self.agents))
                    ) or bool(trunc_d.get("__all__", False))
                    if done or (not by_episodes and steps >= duration):
                        break
                rewards.append(total)
                lens.append(length)
                if not by_episodes and steps >= duration:
                    break
        finally:
            if shared:
                # Re-seat the training rollout: eval stepped the shared env,
                # so the cached obs dict no longer matches its state.
                self._obs_dict, _ = env.reset()
                self._episode_reward = 0.0
            else:
                env.close()
        return rewards, lens

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict({
            "params": host_tree(self.params),
            "target": host_tree(self.target),
            "opt_state": self.opt.state_dict(),
            "timesteps": self._timesteps_total,
            "updates": self._updates,
        })

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        copy_into(self.params, data["params"])
        copy_into(self.target, data["target"])
        if "opt_state" in data:
            self.opt.load_state_dict(data["opt_state"])
        self._timesteps_total = data.get("timesteps", 0)
        self._updates = data.get("updates", 0)

    def cleanup(self) -> None:
        env = getattr(self, "env", None)
        if env is not None:
            env.close()

    def compute_actions(self, obs_dict) -> dict:
        obs_stack = np.stack(
            [np.asarray(obs_dict[a], np.float32).ravel() for a in self.agents]
        )
        q = self._q_values(obs_stack)
        return {a: int(q[i].argmax()) for i, a in enumerate(self.agents)}
