"""AlphaZero — single-player MCTS with learned priors and values.

Reference: rllib/algorithms/alpha_zero/ (alpha_zero.py, mcts.py,
ranked_rewards.py): the reference's "contributed" single-player AlphaZero
— a PUCT Monte-Carlo tree search over a STATE-CLONEABLE environment
(``get_state``/``set_state``), with child priors from the policy network,
leaf evaluation by the value network (no rollouts), Dirichlet noise at the
root, and self-play targets: the policy regresses onto MCTS visit
distributions, the value onto the episode's ranked reward. Single-player
returns are unbounded, so the RANKED-REWARDS (R2) transform binarizes
each return against a percentile of recent self-play returns — the
two-player win/loss signal AlphaZero's value head expects.

The network is the shared RLModule (policy + value heads) on the config's
device (the card unless it asks for the CPU); its update (cross-entropy to
the visit distribution, value MSE, Adam through ``OptaxChain``) runs there
in full f32. The search, the replay and the R2 buffer are numpy on the host,
step for step the JAX package's, from the same ``default_rng(seed)`` stream:
each expansion steps the real cloned env and asks the network once
(``predict``: one forward on the device and ONE read of the probabilities and
the value together). The initial weights are drawn by the port's RLModule
(``rl_module_params_from_jax`` carries the reference's across).
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.off_policy import OffPolicyTraining, floats
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32
from ray_tpu_torch.rllib.core.rl_module import RLModule, _device, tree_leaves


class StateCloneWrapper:
    """Make an env MCTS-plannable: snapshot/restore its state.

    Works for envs whose full dynamics state lives in ``state`` plus step
    counters (CartPole & friends). Other envs can subclass and override
    get_state/set_state (reference: envs used with AlphaZero must provide
    exactly these two methods)."""

    def __init__(self, env, horizon: int = 200):
        # Strip the time limit: its hidden counter is NOT part of get_state,
        # so search simulations would silently consume the real episode's
        # budget. The horizon here replaces it and travels with the cloned
        # state. The reference unwraps gymnasium's TimeLimit; the port's
        # CartPole carries its limit inside (``_max_episode_steps``).
        self.env = getattr(env, "unwrapped", env)
        if hasattr(self.env, "_max_episode_steps"):
            self.env._max_episode_steps = None
        self.horizon = horizon
        self._t = 0

    @property
    def action_space(self):
        return self.env.action_space

    @property
    def observation_space(self):
        return self.env.observation_space

    def reset(self, *, seed=None):
        obs, info = self.env.reset(seed=seed)
        self._t = 0
        return np.asarray(obs, np.float32), info

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(int(action))
        self._t += 1
        if self._t >= self.horizon:
            trunc = True
        return np.asarray(obs, np.float32), float(reward), term, trunc, info

    def get_state(self):
        u = self.env
        # steps_beyond_terminated MUST travel with the state: a terminal
        # step inside one search simulation otherwise poisons the shared
        # env for every later clone (the env latches the flag).
        return (
            copy.deepcopy(u.state),
            getattr(u, "steps_beyond_terminated", None),
            self._t,
        )

    def set_state(self, state):
        u = self.env
        u.state = copy.deepcopy(state[0])
        if hasattr(u, "steps_beyond_terminated"):
            u.steps_beyond_terminated = state[1]
        self._t = state[2]
        return np.asarray(u.state, np.float32)

    def close(self):
        self.env.close()


class _Node:
    __slots__ = (
        "parent", "action", "state", "obs", "reward", "done",
        "expanded", "children", "priors", "child_q_sum", "child_visits",
    )

    def __init__(self, parent, action, state, obs, reward, done, n_actions):
        self.parent = parent
        self.action = action
        self.state = state
        self.obs = obs
        self.reward = reward
        self.done = done
        self.expanded = False
        self.children: dict = {}
        self.priors = np.zeros(n_actions, np.float32)
        self.child_q_sum = np.zeros(n_actions, np.float32)
        self.child_visits = np.zeros(n_actions, np.float32)

    def visits(self):
        return self.parent.child_visits[self.action] if self.parent else 0.0


class MCTS:
    """PUCT search (reference: mcts.py, after brilee/python_uct)."""

    def __init__(self, env, predict, n_actions, *, num_sims=25, c_puct=1.4,
                 gamma=0.997, dirichlet_alpha=0.3, dirichlet_eps=0.25, rng=None):
        self.env = env
        self.predict = predict  # obs -> (prior probs, value)
        self.n_actions = n_actions
        self.num_sims = num_sims
        self.c_puct = c_puct
        self.gamma = gamma
        self.alpha = dirichlet_alpha
        self.eps = dirichlet_eps
        self.rng = rng or np.random.default_rng(0)

    def _select_action(self, node: _Node) -> int:
        q = node.child_q_sum / (1.0 + node.child_visits)
        # Min-max-normalize Q into [0,1] over the values seen THIS search
        # (MuZero's MinMaxStats): PUCT's prior term assumes bounded values,
        # and dense per-step rewards otherwise dwarf it — the search then
        # commits to whichever child it expanded first. With no spread yet
        # (min == max), Q carries NO ranking information, so it contributes
        # zero and the prior/visit term alone drives selection.
        if self._q_max > self._q_min:
            q = np.where(
                node.child_visits > 0,
                (q - self._q_min) / (self._q_max - self._q_min),
                0.0,
            )
        else:
            q = np.zeros_like(q)
        total = max(1.0, node.child_visits.sum())
        u = self.c_puct * math.sqrt(total) * node.priors / (1.0 + node.child_visits)
        return int(np.argmax(q + u))

    def search(self, root_obs, root_state, temperature: float = 1.0):
        self._q_min, self._q_max = float("inf"), float("-inf")
        root = _Node(None, 0, root_state, root_obs, 0.0, False, self.n_actions)
        priors, _ = self.predict(root_obs)
        noise = self.rng.dirichlet([self.alpha] * self.n_actions)
        root.priors = ((1 - self.eps) * priors + self.eps * noise).astype(np.float32)
        root.expanded = True

        for _ in range(self.num_sims):
            node = root
            # SELECT down to a leaf.
            while node.expanded and not node.done:
                a = self._select_action(node)
                child = node.children.get(a)
                if child is None:
                    # EXPAND: step the real env from the parent's state.
                    self.env.set_state(node.state)
                    obs, reward, term, trunc, _ = self.env.step(a)
                    child = _Node(
                        node, a, self.env.get_state(), obs, reward,
                        term or trunc, self.n_actions,
                    )
                    node.children[a] = child
                    node = child
                    break
                node = child
            # EVALUATE the leaf with the value net (no rollouts).
            if node.done:
                value = 0.0
            else:
                priors, value = self.predict(node.obs)
                node.priors = priors.astype(np.float32)
                node.expanded = True
            # BACKUP discounted value + path rewards.
            while node.parent is not None:
                value = node.reward + self.gamma * value
                node.parent.child_q_sum[node.action] += value
                node.parent.child_visits[node.action] += 1.0
                mean_q = (
                    node.parent.child_q_sum[node.action]
                    / (1.0 + node.parent.child_visits[node.action])
                )
                self._q_min = min(self._q_min, mean_q)
                self._q_max = max(self._q_max, mean_q)
                node = node.parent

        visits = root.child_visits
        if temperature <= 1e-6:
            probs = np.zeros_like(visits)
            probs[int(np.argmax(visits))] = 1.0
        else:
            scaled = np.power(visits, 1.0 / temperature)
            probs = scaled / max(scaled.sum(), 1e-8)
        return probs


class RankedRewardsBuffer:
    """R2 transform (reference: ranked_rewards.py): binarize a return
    against a percentile of recent self-play returns."""

    def __init__(self, max_length: int = 100, percentile: float = 75.0, rng=None):
        self.max_length = max_length
        self.percentile = percentile
        self.values: list = []
        self.rng = rng or np.random.default_rng(0)

    def add(self, value: float):
        self.values.append(float(value))
        self.values = self.values[-self.max_length :]

    def normalize(self, value: float) -> float:
        if not self.values:
            return 0.0
        threshold = np.percentile(self.values, self.percentile)
        if value > threshold:
            return 1.0
        if value < threshold:
            return -1.0
        # Tie-break with the ALGORITHM's seeded stream (reproducibility).
        return 1.0 if self.rng.random() < 0.5 else -1.0


def alpha_zero_loss(module: RLModule, obs, target_pi, target_v):
    """(total loss, metrics): cross-entropy of the policy to the visit
    distribution plus the value's squared error, batch means."""
    logits, value = module(obs)
    logp = F.log_softmax(logits, dim=-1)
    pi_loss = -torch.mean(torch.sum(target_pi * logp, dim=-1))
    v_loss = torch.mean(torch.square(value - target_v))
    total = pi_loss + v_loss
    return total, {"pi_loss": pi_loss, "v_loss": v_loss, "total_loss": total}


class AlphaZeroConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or AlphaZero)
        self.lr = 5e-3
        self.num_rollout_workers = 0
        self.train_batch_size = 128
        self.num_sims = 25
        self.c_puct = 1.4
        self.dirichlet_alpha = 0.3
        self.dirichlet_epsilon = 0.25
        self.temperature_timesteps = 2000  # anneal tau 1.0 -> 0.1
        self.episodes_per_iter = 3
        self.updates_per_iter = 20
        self.horizon = 200
        self.replay_capacity = 20_000
        self.ranked_rewards = True
        self.r2_percentile = 75.0
        self.r2_buffer_length = 100
        # Value-head target: "return" regresses each state's DISCOUNTED
        # return-to-go (matches the search's backup semantics — the right
        # choice for dense-reward envs, where an untrained value net gives
        # the search a depth bias until real values fill in); "r2" is the
        # reference's ranked-reward final-outcome target for sparse
        # outcome-style tasks.
        self.value_target = "return"

    def training(self, *, num_sims=None, c_puct=None, dirichlet_alpha=None,
                 dirichlet_epsilon=None, temperature_timesteps=None,
                 episodes_per_iter=None, updates_per_iter=None, horizon=None,
                 replay_capacity=None, ranked_rewards=None, r2_percentile=None,
                 r2_buffer_length=None, value_target=None, **kwargs) -> "AlphaZeroConfig":
        super().training(**kwargs)
        for name, val in (
            ("num_sims", num_sims), ("c_puct", c_puct),
            ("dirichlet_alpha", dirichlet_alpha),
            ("dirichlet_epsilon", dirichlet_epsilon),
            ("temperature_timesteps", temperature_timesteps),
            ("episodes_per_iter", episodes_per_iter),
            ("updates_per_iter", updates_per_iter), ("horizon", horizon),
            ("replay_capacity", replay_capacity),
            ("ranked_rewards", ranked_rewards),
            ("r2_percentile", r2_percentile),
            ("r2_buffer_length", r2_buffer_length),
            ("value_target", value_target),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class AlphaZero(OffPolicyTraining, Algorithm):
    @classmethod
    def get_default_config(cls) -> AlphaZeroConfig:
        return AlphaZeroConfig(cls)

    def setup(self, config: dict) -> None:
        from ray_tpu_torch.rllib.env.cartpole import make
        from ray_tpu_torch.rllib.models import ModelCatalog

        cfg: AlphaZeroConfig = self._algo_config
        self.device = _device(cfg.device)  # no card and no device="cpu": raise before the env
        old_env = getattr(self, "env", None)
        if old_env is not None:
            old_env.close()
        base = make(cfg.env) if isinstance(cfg.env, str) else cfg.env(dict(cfg.env_config))
        assert hasattr(base.action_space, "n"), "AlphaZero needs discrete actions"
        self.env = (
            base if hasattr(base, "get_state") else StateCloneWrapper(base, cfg.horizon)
        )
        self.n_actions = int(base.action_space.n)
        self.spec = ModelCatalog.get_model_spec(
            base.observation_space, base.action_space, cfg.model_config()
        )
        self.module = RLModule(self.spec, seed=cfg.seed, device=self.device)
        self.opt = OptaxChain(tree_leaves(self.module.param_tree()), cfg.lr)
        self._rng = np.random.default_rng(cfg.seed)
        self._timesteps_total = 0
        self._episode_reward_window: list = []
        self.r2 = RankedRewardsBuffer(cfg.r2_buffer_length, cfg.r2_percentile, rng=self._rng)
        self._replay: list = []  # (obs, visit_probs, z)

    @torch.inference_mode()
    def _predict(self, obs):
        """(prior probabilities, value) of one observation: one forward on
        the device and one read of both."""
        x = torch.from_numpy(np.asarray(obs, np.float32)[None]).to(self.device)
        with full_f32(self.device):
            logits, value = self.module(x)
            out = torch.cat([torch.softmax(logits[0], dim=-1), value]).cpu().numpy()
        return out[:-1], float(out[-1])

    def loss_and_grads(self, batch: dict):
        """(metrics, gradients in ``opt.params``' order) of one update's batch
        (``obs``, ``pi``, ``z``: host arrays), on the device in full f32."""
        tb = {k: torch.as_tensor(np.asarray(v, np.float32), device=self.device) for k, v in batch.items()}
        with full_f32(self.device):
            total, aux = alpha_zero_loss(self.module, tb["obs"], tb["pi"], tb["z"])
            grads = torch.autograd.grad(total, self.opt.params)
        return {k: v.detach() for k, v in aux.items()}, grads

    def update(self, batch: dict) -> dict:
        """One update (the reference's jitted ``update``): the loss and its
        gradients, then Adam. Returns the metrics as tensors on the device."""
        aux, grads = self.loss_and_grads(batch)
        self.opt.step(grads)
        return aux

    def _temperature(self) -> float:
        cfg = self._algo_config
        frac = min(1.0, self._timesteps_total / max(cfg.temperature_timesteps, 1))
        return 1.0 + frac * (0.1 - 1.0)

    def _self_play_episode(self) -> float:
        cfg: AlphaZeroConfig = self._algo_config
        mcts = MCTS(
            self.env, self._predict, self.n_actions,
            num_sims=cfg.num_sims, c_puct=cfg.c_puct, gamma=cfg.gamma,
            dirichlet_alpha=cfg.dirichlet_alpha, dirichlet_eps=cfg.dirichlet_epsilon,
            rng=self._rng,
        )
        obs, _ = self.env.reset(seed=int(self._rng.integers(1 << 31)))
        episode: list = []
        rewards: list = []
        total = 0.0
        done = False
        while not done:
            state = self.env.get_state()
            probs = mcts.search(obs, state, temperature=self._temperature())
            action = int(self._rng.choice(self.n_actions, p=probs))
            episode.append((obs, probs))
            # The search left the env in an arbitrary cloned state.
            self.env.set_state(state)
            obs, reward, term, trunc, _ = self.env.step(action)
            rewards.append(reward)
            total += reward
            done = term or trunc
            self._timesteps_total += 1
        if cfg.value_target == "return":
            # Discounted return-to-go per state: the scale the search's
            # backup mixes with real path rewards.
            g = 0.0
            targets = []
            for r in reversed(rewards):
                g = r + cfg.gamma * g
                targets.append(g)
            targets.reverse()
        else:
            z = total
            if cfg.ranked_rewards:
                self.r2.add(total)
                z = self.r2.normalize(total)
            targets = [z] * len(episode)
        for (o, p), z_t in zip(episode, targets):
            self._replay.append((o, p, z_t))
        self._replay = self._replay[-cfg.replay_capacity :]
        return total

    def _replay_batch(self) -> dict:
        cfg: AlphaZeroConfig = self._algo_config
        idx = self._rng.integers(0, len(self._replay), cfg.train_batch_size)
        return {
            "obs": np.stack([self._replay[i][0] for i in idx]),
            "pi": np.stack([self._replay[i][1] for i in idx]),
            "z": np.asarray([self._replay[i][2] for i in idx], np.float32),
        }

    def training_step(self) -> dict:
        cfg: AlphaZeroConfig = self._algo_config
        returns = [self._self_play_episode() for _ in range(cfg.episodes_per_iter)]
        self._episode_reward_window += returns
        self._episode_reward_window = self._episode_reward_window[-100:]
        aux: dict = {}
        if self._replay:
            for _ in range(cfg.updates_per_iter):
                aux = self.update(self._replay_batch())
            aux = floats(aux)  # ONE device sync per iteration
        aux["replay_size"] = float(len(self._replay))
        return aux

    def compute_single_action(self, obs, explore: bool = False, use_mcts: bool = False):
        if use_mcts:
            cfg = self._algo_config
            mcts = MCTS(
                self.env, self._predict, self.n_actions,
                num_sims=cfg.num_sims, c_puct=cfg.c_puct, gamma=cfg.gamma,
                dirichlet_eps=0.0, rng=self._rng,
            )
            state = self.env.get_state()
            probs = mcts.search(np.asarray(obs, np.float32), state, temperature=0.0)
            # The search stepped the env through cloned states: put it back
            # before the caller takes the real step.
            self.env.set_state(state)
            return int(np.argmax(probs))
        probs, _ = self._predict(np.asarray(obs, np.float32))
        return int(np.argmax(probs))

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict({
            "params": self.module.get_params(),
            "opt_state": self.opt.state_dict(),
            "timesteps": self._timesteps_total,
            "r2_values": list(self.r2.values),
            "np_rng_state": self._rng.bit_generator.state,
        })

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        self.module.load_params(data["params"])
        self.opt.load_state_dict(data["opt_state"])
        self._timesteps_total = data.get("timesteps", 0)
        self.r2.values = list(data.get("r2_values", []))
        if "np_rng_state" in data:
            self._rng.bit_generator.state = data["np_rng_state"]
