"""MADDPG — Multi-Agent DDPG with centralized critics.

Reference: rllib/algorithms/maddpg/maddpg.py (Lowe et al. 2017):
decentralized actors ``a_i = mu_i(o_i)`` with CENTRALIZED critics
``Q_i(o_1..o_N, a_1..a_N)`` — each agent's critic sees every agent's
observation and action during training, which removes the non-stationarity
that breaks independent DDPG in multi-agent settings. Execution stays
decentralized (actors only need their own observation).

All agents share one architecture, so per-agent parameters are STACKED along
a leading axis N (``w`` [N, din, dout], ``b`` [N, dout]), as the reference
stacks them for ``jax.vmap``; here every forward over the stack is one
batched matmul (``[N, B, din] @ [N, din, dout]``), on the config's device
(the card by default). The optimizer is the reference's
``optax.multi_transform``: the actor subtree and the critic subtree each
clipped by their OWN global norm (0.5) and stepped by their own Adam (``lr``
and ``critic_lr``). Exploration noise and replay sampling are numpy, seeded
as the reference seeds them.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.off_policy import (
    OffPolicyTraining,
    floats,
    frozen,
    mlp_params,
    mlp_params_from_jax,
    polyak,
    trainable,
)
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32, global_norm
from ray_tpu_torch.rllib.core.rl_module import _device, tree_leaves, tree_map
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv
from ray_tpu_torch.rllib.utils.replay_buffers import ColumnReplayBuffer


def maddpg_params_from_jax(params: dict, *, device="cuda") -> dict:
    """The reference's stacked MADDPG params or targets (``actor``,
    ``critic``: lists of ``{"w": [N, din, dout], "b": [N, dout]}``) as the
    port's tree on ``device``."""
    return {k: mlp_params_from_jax(v, device=device) for k, v in params.items()}


def stacked_mlp(layers, x):
    """Each agent's MLP on its own rows: ``x`` [N, B, din] -> [N, B, dout]
    (``jax.vmap`` of the reference's ``_mlp_apply`` over the leading axis)."""
    for layer in layers[:-1]:
        x = torch.relu(torch.matmul(x, layer["w"]) + layer["b"][:, None, :])
    return torch.matmul(x, layers[-1]["w"]) + layers[-1]["b"][:, None, :]


def maddpg_loss(params, target_params, batch, *, gamma):
    """(total loss, metrics) of one MADDPG batch of tensors (``obs`` [B, N,
    obs], ``actions`` [B, N, act], ``rewards`` [B, N], ``dones`` [B],
    ``next_obs`` [B, N, obs])."""
    obs, acts, rews = batch["obs"], batch["actions"], batch["rewards"]
    dones, next_obs = batch["dones"], batch["next_obs"]
    B, N = obs.shape[0], obs.shape[1]
    with torch.no_grad():
        # Target joint action: each agent's target actor on ITS obs.
        next_a = torch.tanh(stacked_mlp(target_params["actor"], next_obs.transpose(0, 1))).transpose(0, 1)
        next_global = torch.cat([next_obs.reshape(B, -1), next_a.reshape(B, -1)], dim=-1)
        q_next = stacked_mlp(target_params["critic"], next_global.expand(N, B, -1))[..., 0].transpose(0, 1)
        y = rews + gamma * (1.0 - dones[:, None]) * q_next  # [B, N]

    global_in = torch.cat([obs.reshape(B, -1), acts.reshape(B, -1)], dim=-1)
    q = stacked_mlp(params["critic"], global_in.expand(N, B, -1))[..., 0].transpose(0, 1)  # [B, N]
    critic_loss = torch.mean(torch.square(q - y))

    # Actor i maximizes Q_i with ITS action replaced by mu_i(o_i) and the
    # other agents' actions from the batch (stop-grad through them is
    # implicit: they are data).
    mu = torch.tanh(stacked_mlp(params["actor"], obs.transpose(0, 1))).transpose(0, 1)  # [B, N, act]
    eye = torch.eye(N, dtype=obs.dtype, device=obs.device)[None, :, :, None]  # [1, N, N, 1]
    # joint_i: batch actions with column i swapped for mu_i;
    # joint[b, i, j, :] = action of agent j in agent i's critic input.
    joint = acts[:, None, :, :] * (1.0 - eye) + mu[:, :, None, :].transpose(1, 2) * eye
    global_a = torch.cat(
        [obs.reshape(B, 1, -1).expand(B, N, N * obs.shape[2]), joint.reshape(B, N, -1)], dim=-1
    )  # [B, N, global]
    # Critic params are FROZEN in the actor term — without the stop-gradient
    # the actor objective would "improve" by inflating the critic's Q
    # estimates instead of the policy.
    q_pi = stacked_mlp(frozen(params["critic"]), global_a.transpose(0, 1))[..., 0].transpose(0, 1)  # [B, N]
    actor_loss = -torch.mean(q_pi)
    return critic_loss + actor_loss, {
        "critic_loss": critic_loss,
        "actor_loss": actor_loss,
        "q_mean": q.mean(),
    }


class MADDPGConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MADDPG)
        self.lr = 1e-3
        self.critic_lr = 1e-3
        self.num_rollout_workers = 0
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.learning_starts = 1000
        self.tau = 1e-2
        self.rollout_steps_per_iter = 500
        self.train_intensity = 4      # env steps per gradient update
        self.exploration_noise = 0.2  # gaussian, in [-1,1] action units
        self.model_hiddens = (64, 64)

    def training(self, *, critic_lr=None, replay_buffer_capacity=None,
                 learning_starts=None, tau=None, rollout_steps_per_iter=None,
                 train_intensity=None, exploration_noise=None,
                 model_hiddens=None, **kwargs) -> "MADDPGConfig":
        super().training(**kwargs)
        for name, val in (
            ("critic_lr", critic_lr),
            ("replay_buffer_capacity", replay_buffer_capacity),
            ("learning_starts", learning_starts),
            ("tau", tau),
            ("rollout_steps_per_iter", rollout_steps_per_iter),
            ("train_intensity", train_intensity),
            ("exploration_noise", exploration_noise),
            ("model_hiddens", model_hiddens),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class MADDPG(OffPolicyTraining, Algorithm):
    _target_attr = "target_params"

    @classmethod
    def get_default_config(cls) -> MADDPGConfig:
        return MADDPGConfig(cls)

    def setup(self, config: dict) -> None:
        cfg: MADDPGConfig = self._algo_config
        self.device = _device(cfg.device)  # no card and no device="cpu": raise first
        env = cfg.env(dict(cfg.env_config)) if callable(cfg.env) else cfg.env
        assert isinstance(env, MultiAgentEnv), "MADDPG requires a MultiAgentEnv"
        self.env = env
        self.agents = list(env.possible_agents)
        self.n_agents = len(self.agents)
        self.obs_dim = int(np.prod(env.observation_space.shape))
        space = env.action_space
        assert hasattr(space, "shape") and space.shape, "MADDPG needs continuous actions"
        self.act_dim = int(np.prod(space.shape))
        low = np.asarray(space.low, np.float32)
        high = np.asarray(space.high, np.float32)
        self._act_scale = (high - low) / 2.0
        self._act_offset = (high + low) / 2.0

        N, H = self.n_agents, cfg.model_hiddens
        global_dim = N * (self.obs_dim + self.act_dim)
        gen = torch.Generator().manual_seed(int(cfg.seed))
        # Stacked per-agent params: tree leaves have leading axis N.
        actor = [mlp_params(gen, self.obs_dim, H, self.act_dim) for _ in range(N)]
        critic = [mlp_params(gen, global_dim, H, 1) for _ in range(N)]

        def stack(trees):
            return [{k: torch.stack([t[i][k] for t in trees]) for k in ("w", "b")} for i in range(len(trees[0]))]

        self.params = trainable(tree_map(lambda t: t.to(self.device), {"actor": stack(actor),
                                                                         "critic": stack(critic)}), self.device)
        self.target_params = tree_map(lambda t: t.detach().clone(), self.params)
        # Split learning rates (standard MADDPG: critics usually train
        # faster than actors) via per-subtree transforms, each clipped by
        # its own global norm.
        self.opt = {
            "actor": OptaxChain(tree_leaves(self.params["actor"]), cfg.lr, 0.5),
            "critic": OptaxChain(tree_leaves(self.params["critic"]), cfg.critic_lr, 0.5),
        }
        self.buffer = ColumnReplayBuffer(cfg.replay_buffer_capacity, cfg.seed)
        self._timesteps_total = 0
        self._updates = 0
        self._episode_reward_window: list = []
        self._np_rng = np.random.default_rng(cfg.seed)
        self._obs = self._obs_dict_to_array(self.env.reset(seed=cfg.seed)[0])
        self._ep_reward = 0.0

    # -- helpers ---------------------------------------------------------

    def _obs_dict_to_array(self, obs_dict: dict) -> np.ndarray:
        return np.stack(
            [np.asarray(obs_dict[a], np.float32).reshape(-1) for a in self.agents]
        )

    def _scale(self, a: np.ndarray) -> np.ndarray:
        return a * self._act_scale + self._act_offset

    @torch.no_grad()
    def _actors_fwd(self, obs: np.ndarray) -> np.ndarray:
        """Each agent's actor on its own observation ([N, obs] -> [N, act]):
        one forward on the device, the actions back in one read."""
        x = torch.from_numpy(np.require(obs, np.float32, "W")).to(self.device)[:, None, :]
        with full_f32(self.device):
            return torch.tanh(stacked_mlp(self.params["actor"], x))[:, 0, :].cpu().numpy()

    # -- training --------------------------------------------------------

    def training_step(self) -> dict:
        cfg: MADDPGConfig = self._algo_config
        metrics: dict = {}
        for _ in range(cfg.rollout_steps_per_iter):
            a = self._actors_fwd(self._obs)
            a = np.clip(a + self._np_rng.normal(0, cfg.exploration_noise, a.shape), -1, 1)
            action_dict = {ag: self._scale(a[i]) for i, ag in enumerate(self.agents)}
            obs_d, rew_d, term_d, trunc_d, _ = self.env.step(action_dict)
            done = bool(term_d.get("__all__")) or bool(trunc_d.get("__all__"))
            rewards = np.asarray([rew_d.get(ag, 0.0) for ag in self.agents], np.float32)
            next_obs = (
                self._obs_dict_to_array(obs_d)
                if obs_d
                else np.zeros_like(self._obs)
            )
            self.buffer.add({
                "obs": self._obs, "actions": a.astype(np.float32),
                "rewards": rewards, "dones": np.float32(done),
                "next_obs": next_obs,
            })
            self._ep_reward += float(rewards.sum())
            self._timesteps_total += 1
            if done:
                self._episode_reward_window.append(self._ep_reward)
                self._episode_reward_window = self._episode_reward_window[-100:]
                self._ep_reward = 0.0
                self._obs = self._obs_dict_to_array(self.env.reset()[0])
            else:
                self._obs = next_obs
            if (
                len(self.buffer) >= cfg.learning_starts
                and self._timesteps_total % max(1, cfg.train_intensity) == 0
            ):
                metrics = self._train_once()
        return metrics

    def loss_and_grads(self, batch: dict):
        """(total loss, metrics, the actor's and the critic's gradients) of
        one batch of tensors on the device, in full f32."""
        with full_f32(self.device):
            total, aux = maddpg_loss(self.params, self.target_params, batch, gamma=self._algo_config.gamma)
            grads = torch.autograd.grad(total, tree_leaves(self.params["actor"]) + tree_leaves(self.params["critic"]))
        n_actor = len(tree_leaves(self.params["actor"]))
        return total, aux, list(grads[:n_actor]), list(grads[n_actor:])

    def update(self, batch: dict) -> dict:
        """One MADDPG step (the reference's jitted ``update_fn``) from a host
        batch: each subtree's gradients clipped by their own global norm and
        stepped by their own Adam, then every target toward the updated
        params. Returns the metrics as tensors on the device."""
        tb = {k: torch.from_numpy(np.require(np.asarray(v), np.float32, "W")).to(self.device)
              for k, v in batch.items()}
        total, aux, actor_grads, critic_grads = self.loss_and_grads(tb)
        with full_f32(self.device):
            self.opt["actor"].step(actor_grads, global_norm(actor_grads))
            self.opt["critic"].step(critic_grads, global_norm(critic_grads))
        polyak(tree_leaves(self.target_params), tree_leaves(self.params), self._algo_config.tau)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["total_loss"] = total.detach()
        return aux

    def _train_once(self) -> dict:
        aux = self.update(self.buffer.sample(self._algo_config.train_batch_size))
        self._updates += 1
        return floats(aux)

    def compute_actions(self, obs_dict: dict) -> dict:
        """Decentralized execution: each agent acts from its own obs."""
        a = self._actors_fwd(self._obs_dict_to_array(obs_dict))
        return {ag: self._scale(a[i]) for i, ag in enumerate(self.agents)}

    def _evaluate_local(self, duration: int, by_episodes: bool):
        """Greedy (noise-free) multi-agent episodes; team reward per episode.
        Overrides the base single-agent eval loop — MADDPG envs take action
        DICTS and report per-agent rewards."""
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
                    total += float(sum(rew_d.get(ag, 0.0) for ag in self.agents))
                    length += 1
                    steps += 1
                    done = bool(term_d.get("__all__")) or bool(trunc_d.get("__all__"))
                    if done or (not by_episodes and steps >= duration):
                        break
                rewards.append(total)
                lens.append(length)
                if not by_episodes and steps >= duration:
                    break
        finally:
            if shared:
                # Re-seat the training rollout on a fresh episode: eval
                # stepped the shared env, so the cached obs is stale.
                self._obs = self._obs_dict_to_array(env.reset()[0])
                self._ep_reward = 0.0
            else:
                try:
                    env.close()
                except Exception:
                    pass
        return rewards, lens
