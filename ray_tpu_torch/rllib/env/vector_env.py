"""Vectorized environment layer.

Reference: rllib/env/vector_env.py (VectorEnv / _VectorizedGymEnv) with the
gymnasium API. Environments step on CPU rollout actors; the learner never
touches them — the same split as the reference (env stepping on CPU actors,
SGD on accelerator learners, §3.6 of the survey).

An env id goes through ``env.cartpole.make``: ``CartPole-v1`` and
``Pendulum-v1`` are the port's own numpy envs, any other id needs gymnasium.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class EnvContext(dict):
    """Env config dict + worker/vector indices (reference: env/env_context.py)."""

    def __init__(self, config: dict, worker_index: int = 0, vector_index: int = 0):
        super().__init__(config or {})
        self.worker_index = worker_index
        self.vector_index = vector_index


def _make_env(env_spec, ctx: EnvContext):
    if callable(env_spec):
        return env_spec(ctx)
    if isinstance(env_spec, str):
        from ray_tpu_torch.rllib.env.cartpole import make

        return make(env_spec)
    raise ValueError(f"cannot build env from {env_spec!r}")


class VectorEnv:
    """N sub-envs stepped as a batch, with auto-reset on termination."""

    def __init__(self, env_spec, num_envs: int, config: Optional[dict] = None, worker_index: int = 0, seed: Optional[int] = None):
        self.envs = [
            _make_env(env_spec, EnvContext(config or {}, worker_index, i))
            for i in range(num_envs)
        ]
        self.num_envs = num_envs
        self._eps_ids = np.arange(num_envs, dtype=np.int64)
        self._next_eps_id = num_envs
        self._episode_rewards = np.zeros(num_envs, dtype=np.float64)
        self._episode_lens = np.zeros(num_envs, dtype=np.int64)
        self.completed_rewards: List[float] = []
        self.completed_lens: List[int] = []
        obs = []
        for i, env in enumerate(self.envs):
            o, _info = env.reset(seed=None if seed is None else seed + i)
            obs.append(o)
        self._obs = np.stack(obs)

    @property
    def observation_space(self):
        return self.envs[0].observation_space

    @property
    def action_space(self):
        return self.envs[0].action_space

    def current_obs(self) -> np.ndarray:
        return self._obs

    def eps_ids(self) -> np.ndarray:
        return self._eps_ids.copy()

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
        """Step every sub-env; returns (next_obs, rewards, dones, infos).
        Terminated/truncated envs auto-reset; `dones` marks the boundary."""
        next_obs, rewards, dones, infos = [], [], [], []
        for i, env in enumerate(self.envs):
            o, r, terminated, truncated, info = env.step(np.asarray(actions[i]))
            done = bool(terminated or truncated)
            # Truncation vs termination matters to off-policy bootstrapping
            # (a time-limit cut must still bootstrap V/Q(s')), so the split
            # flags and the pre-reset observation ride in the info dict.
            info = dict(info)
            info["terminated"] = bool(terminated)
            info["truncated"] = bool(truncated)
            self._episode_rewards[i] += float(r)
            self._episode_lens[i] += 1
            if done:
                info["final_observation"] = o
                self.completed_rewards.append(float(self._episode_rewards[i]))
                self.completed_lens.append(int(self._episode_lens[i]))
                self._episode_rewards[i] = 0.0
                self._episode_lens[i] = 0
                self._eps_ids[i] = self._next_eps_id
                self._next_eps_id += 1
                o, _ = env.reset()
            next_obs.append(o)
            rewards.append(float(r))
            dones.append(done)
            infos.append(info)
        self._obs = np.stack(next_obs)
        return self._obs, np.asarray(rewards, np.float32), np.asarray(dones), infos

    def pop_episode_stats(self) -> Tuple[List[float], List[int]]:
        r, l = self.completed_rewards, self.completed_lens
        self.completed_rewards, self.completed_lens = [], []
        return r, l

    def close(self):
        for env in self.envs:
            try:
                env.close()
            except Exception:
                pass


class MultiAgentVectorEnv:
    """Slot-flattened multi-agent stepping: every (env, agent) pair is one
    vector slot, so the single-policy rollout path (GAE over fragments,
    shared parameters — the reference's default policy mapping) works
    unchanged on MultiAgentEnvs.

    Two supported termination shapes (see multi_agent_env.py):
    - ``agent_auto_reset`` envs keep every agent live (independent copies);
    - lockstep envs end all agents together via ``terminateds["__all__"]``.
    Envs where agents die at different times without auto-reset are not
    representable as fixed slots; use lockstep design or the wrapper.
    """

    def __init__(self, env_spec, num_envs: int, config: Optional[dict] = None,
                 worker_index: int = 0, seed: Optional[int] = None):
        self.envs = [
            _make_env(env_spec, EnvContext(config or {}, worker_index, i))
            for i in range(num_envs)
        ]
        self.agents = list(self.envs[0].possible_agents)
        self.n_agents = len(self.agents)
        self.num_envs = num_envs * self.n_agents  # slots
        self._auto = bool(getattr(self.envs[0], "agent_auto_reset", False))
        self._eps_ids = np.arange(self.num_envs, dtype=np.int64)
        self._next_eps_id = self.num_envs
        self._episode_rewards = np.zeros(self.num_envs, dtype=np.float64)
        self._episode_lens = np.zeros(self.num_envs, dtype=np.int64)
        self.completed_rewards: List[float] = []
        self.completed_lens: List[int] = []
        obs = []
        for i, env in enumerate(self.envs):
            # Stride env seeds so per-agent offsets inside one env can't
            # collide with a sibling env's agents.
            od, _ = env.reset(seed=None if seed is None else seed + i * 1000003)
            obs += [od[a] for a in self.agents]
        self._obs = np.stack(obs)

    @property
    def observation_space(self):
        return self.envs[0].observation_space

    @property
    def action_space(self):
        return self.envs[0].action_space

    def current_obs(self) -> np.ndarray:
        return self._obs

    def eps_ids(self) -> np.ndarray:
        return self._eps_ids.copy()

    def _slot(self, env_i: int, agent_i: int) -> int:
        return env_i * self.n_agents + agent_i

    def step(self, actions: np.ndarray):
        next_obs = [None] * self.num_envs
        rewards = np.zeros(self.num_envs, np.float32)
        dones = np.zeros(self.num_envs, bool)
        infos: list = [{} for _ in range(self.num_envs)]
        for e, env in enumerate(self.envs):
            action_dict = {
                a: np.asarray(actions[self._slot(e, i)]) for i, a in enumerate(self.agents)
            }
            od, rd, td, cd, infod = env.step(action_dict)
            all_done = bool(td.get("__all__", False) or cd.get("__all__", False))
            if all_done and not self._auto:
                reset_obs, _ = env.reset()
            for i, a in enumerate(self.agents):
                s = self._slot(e, i)
                r = float(rd.get(a, 0.0))
                done = bool(td.get(a, False) or cd.get(a, False) or all_done)
                rewards[s] = r
                dones[s] = done
                info = dict(infod.get(a, {}))
                info["terminated"] = bool(td.get(a, False) or (all_done and not cd.get(a, False)))
                info["truncated"] = bool(cd.get(a, False))
                self._episode_rewards[s] += r
                self._episode_lens[s] += 1
                if done:
                    # Prefer the env-provided terminal obs (auto-resetting
                    # envs already replaced od[a] with the fresh episode's
                    # first obs).
                    info.setdefault("final_observation", od.get(a, self._obs[s]))
                    self.completed_rewards.append(float(self._episode_rewards[s]))
                    self.completed_lens.append(int(self._episode_lens[s]))
                    self._episode_rewards[s] = 0.0
                    self._episode_lens[s] = 0
                    self._eps_ids[s] = self._next_eps_id
                    self._next_eps_id += 1
                if all_done and not self._auto:
                    next_obs[s] = reset_obs[a]
                else:
                    next_obs[s] = od.get(a, self._obs[s])
                infos[s] = info
        self._obs = np.stack(next_obs)
        return self._obs, rewards, dones, infos

    def pop_episode_stats(self):
        r, l = self.completed_rewards, self.completed_lens
        self.completed_rewards, self.completed_lens = [], []
        return r, l

    def close(self):
        for env in self.envs:
            try:
                env.close()
            except Exception:
                pass


def make_vector_env(env_spec, num_envs: int, config: Optional[dict] = None,
                    worker_index: int = 0, seed: Optional[int] = None):
    """VectorEnv for gym envs, MultiAgentVectorEnv for MultiAgentEnvs
    (probed by building one instance)."""
    from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv

    probe = _make_env(env_spec, EnvContext(config or {}, worker_index, 0))
    is_multi = isinstance(probe, MultiAgentEnv)
    try:
        probe.close()
    except Exception:
        pass
    cls = MultiAgentVectorEnv if is_multi else VectorEnv
    return cls(env_spec, num_envs, config, worker_index, seed=seed)
