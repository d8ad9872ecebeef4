"""ExternalEnv — inverted-control environments.

Reference: rllib/env/external_env.py:23 — the ENVIRONMENT owns the loop
(a game server, robot, or web client decides when steps happen) and the
algorithm is a service it queries: ``start_episode`` / ``get_action`` /
``log_returns`` / ``end_episode``. The user subclasses ``ExternalEnv``
and implements ``run()``, which executes on its own thread for the life
of the algorithm.

Completed episodes accumulate as SampleBatches, the same contract
``PolicyServerInput`` uses (policy_server.py), so any algorithm that can
consume collected batches (DQN-family via replay, MARWIL/BC/CQL readers)
trains directly from an external sim; ``ExternalEnvRunner`` is the small
pump that drives sampling for them.

Numpy and threading only, as in the JAX package: the actions it serves are
the algorithm's ``compute_single_action``, which runs on the algorithm's
device (the card unless its config asks for the CPU).
"""

from __future__ import annotations

import queue
import threading
import uuid
from typing import Callable, Optional

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    DONES,
    EPS_ID,
    NEXT_OBS,
    OBS,
    REWARDS,
    SampleBatch,
)


class _EpisodeState:
    def __init__(self, eid: str, idx: int):
        self.eid = eid
        self.idx = idx
        self.obs: list = []
        self.actions: list = []
        self.rewards: list = []
        self.pending_reward = 0.0


class ExternalEnv(threading.Thread):
    """Subclass and implement ``run()`` (reference: external_env.py:23).

    Inside ``run()`` call:
      - ``eid = self.start_episode()``
      - ``action = self.get_action(eid, obs)``   (served by the live policy)
      - ``self.log_returns(eid, reward)``
      - ``self.end_episode(eid, final_obs)``
    """

    def __init__(self, action_space=None, observation_space=None):
        super().__init__(daemon=True, name=type(self).__name__)
        self.action_space = action_space
        self.observation_space = observation_space
        self._policy_fn: Optional[Callable] = None
        self._policy_ready = threading.Event()
        self._episodes: dict[str, _EpisodeState] = {}
        self._eps_counter = 0
        self._completed: queue.Queue = queue.Queue()
        self._lock = threading.Lock()

    # -- wiring (called by the runner/algorithm side) --------------------

    def set_policy_fn(self, fn: Callable):
        """fn(obs: np.ndarray) -> action. Installed by the runner before
        the env thread may request actions."""
        self._policy_fn = fn
        self._policy_ready.set()

    # -- user-facing API (called from run()) -----------------------------

    def run(self):  # pragma: no cover - subclass responsibility
        raise NotImplementedError

    def start_episode(self, episode_id: Optional[str] = None) -> str:
        eid = episode_id or uuid.uuid4().hex
        with self._lock:
            self._episodes[eid] = _EpisodeState(eid, self._eps_counter)
            self._eps_counter += 1
        return eid

    def get_action(self, episode_id: str, observation):
        self._policy_ready.wait()
        ep = self._episodes[episode_id]
        obs = np.asarray(observation, dtype=np.float32)
        action = self._policy_fn(obs)
        with self._lock:
            if ep.obs:
                ep.rewards.append(ep.pending_reward)
            ep.pending_reward = 0.0
            ep.obs.append(obs)
            ep.actions.append(action)
        return action

    def log_action(self, episode_id: str, observation, action):
        """Off-policy logging: the external system chose `action` itself."""
        ep = self._episodes[episode_id]
        with self._lock:
            if ep.obs:
                ep.rewards.append(ep.pending_reward)
            ep.pending_reward = 0.0
            ep.obs.append(np.asarray(observation, dtype=np.float32))
            ep.actions.append(action)

    def log_returns(self, episode_id: str, reward: float):
        ep = self._episodes[episode_id]
        with self._lock:
            ep.pending_reward += float(reward)

    def end_episode(self, episode_id: str, observation=None):
        with self._lock:
            ep = self._episodes.pop(episode_id, None)
        if ep is None or not ep.obs:
            return
        ep.rewards.append(ep.pending_reward)
        obs = np.stack(ep.obs)
        final = (
            np.asarray(observation, dtype=np.float32)[None]
            if observation is not None
            else obs[-1:]
        )
        next_obs = np.concatenate([obs[1:], final])
        n = len(ep.obs)
        dones = np.zeros(n, dtype=np.float32)
        dones[-1] = 1.0
        batch = SampleBatch({
            OBS: obs,
            ACTIONS: np.asarray(ep.actions),
            REWARDS: np.asarray(ep.rewards, dtype=np.float32),
            NEXT_OBS: next_obs,
            DONES: dones,
            EPS_ID: np.full(n, ep.idx, dtype=np.int64),
        })
        self._completed.put(batch)

    # -- consumption (runner side) ---------------------------------------

    def poll_batch(self, timeout: float = 1.0) -> Optional[SampleBatch]:
        try:
            return self._completed.get(timeout=timeout)
        except queue.Empty:
            return None


class ExternalEnvRunner:
    """Pumps an ExternalEnv's completed episodes into an off-policy
    algorithm's replay buffer and serves its live policy for get_action
    (reference: ExternalEnv rollout integration in rollout_worker.py)."""

    def __init__(self, env: ExternalEnv, algorithm):
        self.env = env
        self.algorithm = algorithm
        env.set_policy_fn(lambda obs: algorithm.compute_single_action(obs, explore=True))
        if not env.is_alive():
            env.start()

    def collect(self, min_steps: int, timeout: float = 30.0) -> int:
        """Blocks until ≥min_steps env steps are ingested; returns steps."""
        import time as _time

        steps = 0
        deadline = _time.monotonic() + timeout
        while steps < min_steps and _time.monotonic() < deadline:
            batch = self.env.poll_batch(timeout=0.5)
            if batch is None:
                continue
            # The DQN-family replay stores transition columns only; EPS_ID
            # (kept on poll_batch() for offline-dataset consumers) would
            # diverge from a buffer initialized by internal rollouts.
            replay = SampleBatch({k: v for k, v in batch.items() if k != EPS_ID})
            self.algorithm.buffer.add(replay)
            n = len(batch[REWARDS])
            steps += n
            self.algorithm._timesteps_total += n
            ep_reward = float(np.sum(batch[REWARDS]))
            window = getattr(self.algorithm, "_episode_reward_window", None)
            if window is not None:
                window.append(ep_reward)
                del window[:-100]
        return steps
