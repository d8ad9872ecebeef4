"""Connector implementations (reference: rllib/connectors/connector.py:320
``ConnectorPipeline``, agent/pipeline.py:21 ``AgentConnectorPipeline``,
action/pipeline.py, agent/{mean_std_filter,clip,flatten,view_requirement}.py,
action/{clip,normalize}.py).

Agent connectors shape observation batches on the way INTO the policy;
action connectors shape sampled actions on the way OUT to the env. Both
compose into serializable pipelines used by rollout AND eval workers
(evaluation/rollout_worker.py builds one of each per worker)."""

from __future__ import annotations

import numpy as np


class AgentConnector:
    """obs batch [N, ...] -> obs batch. Override __call__ (+ state hooks for
    stateful connectors)."""

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, obs: np.ndarray) -> np.ndarray:
        """Apply WITHOUT updating learned statistics (evaluation path).
        Temporal-context connectors (frame stacking) still advance their
        buffers here — episode context is not a learned statistic."""
        return self(obs)

    def peek(self, obs: np.ndarray) -> np.ndarray:
        """Apply with NO state change at all — not even temporal buffers.
        Used for out-of-band forwards over an observation the stepping loop
        will shape again (bootstrap values at fragment boundaries), which
        must not double-push frames."""
        return self.transform(obs)

    def on_episode_done(self, done_mask) -> None:
        """Per-slot episode boundary hook (frame stacks reset here)."""

    # Stateful connectors override these; stateless return None / ignore.
    def get_state(self):
        return None

    def set_state(self, state):
        pass

    def merge_states(self, states: list):
        """Combine per-worker states (driver-side reduce)."""
        pass


class ActionConnector:
    def __call__(self, actions: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class ClipObservations(AgentConnector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, obs):
        return np.clip(obs, self.low, self.high)


class FlattenObservations(AgentConnector):
    def __call__(self, obs):
        return np.asarray(obs).reshape(len(obs), -1)


class MeanStdFilter(AgentConnector):
    """Running per-feature normalization (reference:
    rllib/utils/filter.py MeanStdFilter as an agent connector): Welford
    accumulation per worker, merged across workers with the Chan formula when
    weights sync."""

    def __init__(self, clip: float = 10.0):
        self.clip = clip
        self._count = 0
        self._mean: np.ndarray | None = None
        self._m2: np.ndarray | None = None

    def __call__(self, obs):
        obs = np.asarray(obs, np.float64)
        n = obs.shape[0]
        if n:
            # Vectorized batch statistics folded in with the Chan formula —
            # this runs on every env step, a per-row Python loop would
            # dominate rollout cost.
            b_mean = obs.mean(axis=0)
            b_m2 = ((obs - b_mean) ** 2).sum(axis=0)
            if self._mean is None:
                self._count, self._mean, self._m2 = n, b_mean, b_m2
            else:
                total = self._count + n
                delta = b_mean - self._mean
                self._mean = self._mean + delta * n / total
                self._m2 = self._m2 + b_m2 + delta * delta * self._count * n / total
                self._count = total
        return self.transform(obs)

    def transform(self, obs):
        """Normalize WITHOUT updating statistics (evaluation path)."""
        if self._mean is None or self._count < 2:
            return np.asarray(obs, np.float32)
        std = np.sqrt(self._m2 / (self._count - 1)) + 1e-8
        out = (np.asarray(obs, np.float64) - self._mean) / std
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def get_state(self):
        return {
            "count": self._count,
            "mean": None if self._mean is None else self._mean.copy(),
            "m2": None if self._m2 is None else self._m2.copy(),
        }

    def set_state(self, state):
        self._count = state["count"]
        self._mean = None if state["mean"] is None else np.array(state["mean"])
        self._m2 = None if state["m2"] is None else np.array(state["m2"])

    def merge_states(self, states: list):
        """Chan parallel-variance merge of per-worker accumulations."""
        count, mean, m2 = 0, None, None
        for st in states:
            if not st or st["count"] == 0 or st["mean"] is None:
                continue
            if mean is None:
                count, mean, m2 = st["count"], np.array(st["mean"]), np.array(st["m2"])
                continue
            n2 = st["count"]
            delta = st["mean"] - mean
            total = count + n2
            mean = mean + delta * n2 / total
            m2 = m2 + st["m2"] + delta * delta * count * n2 / total
            count = total
        self._count, self._mean, self._m2 = count, mean, m2


class ObsPreprocessor(AgentConnector):
    """Arbitrary stateless observation preprocessing stage (reference:
    agent/obs_preproc.py ObsPreprocessorConnector). ``fn`` maps an obs batch
    to an obs batch and must be picklable (it ships to the workers)."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, obs):
        return self.fn(obs)


class FrameStack(AgentConnector):
    """Stack the last ``num_frames`` observations per env slot along the
    last axis (reference: frame-stacking via view requirements /
    trajectory view API). Stateful per EPISODE, not per dataset: buffers
    advance in both train and eval (transform == __call__ for temporal
    context), and ``on_episode_done`` re-seeds finished slots so frames
    never leak across episodes — the first obs of a new episode is
    repeated ``num_frames`` times, the standard Atari convention."""

    def __init__(self, num_frames: int = 4):
        if num_frames < 1:
            raise ValueError("num_frames must be >= 1")
        self.num_frames = num_frames
        self._frames: np.ndarray | None = None  # [N, k, ...feature]
        self._reseed: np.ndarray | None = None  # slots to re-seed next call

    def _advanced(self, obs):
        """(frames, reseed) as they would be after pushing ``obs``."""
        obs = np.asarray(obs)
        n = obs.shape[0]
        if self._frames is None or self._frames.shape[0] != n:
            return np.repeat(obs[:, None], self.num_frames, axis=1), np.zeros(n, bool)
        frames = np.roll(self._frames, -1, axis=1)
        frames[:, -1] = obs
        reseed = self._reseed.copy()
        if reseed.any():
            idx = np.where(reseed)[0]
            frames[idx] = obs[idx][:, None]
            reseed[:] = False
        return frames, reseed

    @staticmethod
    def _stacked(frames):
        # [N, k, ...F] -> [N, ...F*k] on the last axis
        return np.concatenate(list(frames.transpose(1, 0, *range(2, frames.ndim))), axis=-1)

    def __call__(self, obs):
        self._frames, self._reseed = self._advanced(obs)
        return self._stacked(self._frames)

    def peek(self, obs):
        frames, _ = self._advanced(obs)
        return self._stacked(frames)

    def on_episode_done(self, done_mask):
        if self._reseed is not None:
            self._reseed |= np.asarray(done_mask, dtype=bool)

    def get_state(self):
        return {
            "frames": None if self._frames is None else self._frames.copy(),
            "reseed": None if self._reseed is None else self._reseed.copy(),
        }

    def set_state(self, state):
        self._frames = None if state["frames"] is None else np.array(state["frames"])
        self._reseed = None if state["reseed"] is None else np.array(state["reseed"])


class ViewRequirementConnector(AgentConnector):
    """Coerce the observation batch to the policy's declared view
    (reference: agent/view_requirement.py ViewRequirementAgentConnector):
    cast to ``dtype``, optionally flatten features, and VALIDATE the final
    feature size against the module spec's input dim — a shape mismatch
    fails here with the pipeline's name attached instead of deep inside
    the forward."""

    def __init__(self, input_dim: int | None = None, flatten: bool = True, dtype=np.float32):
        self.input_dim = input_dim
        self.flatten = flatten
        self.dtype = dtype

    def __call__(self, obs):
        obs = np.asarray(obs, dtype=self.dtype)
        if self.flatten and obs.ndim > 2:
            obs = obs.reshape(obs.shape[0], -1)
        if self.input_dim is not None and obs.shape[-1] != self.input_dim:
            raise ValueError(
                f"view requirement mismatch: policy expects feature dim "
                f"{self.input_dim}, connector output has {obs.shape[-1]}"
            )
        return obs


class ClipActions(ActionConnector):
    def __init__(self, low, high):
        self.low, self.high = np.asarray(low), np.asarray(high)

    def __call__(self, actions):
        return np.clip(actions, self.low, self.high)


class UnsquashActions(ActionConnector):
    """Map policy outputs in [-1, 1] to the env's Box bounds (reference:
    action/normalize.py NormalizeActionsConnector / unsquash_action): the
    affine stretch of tanh-squashed gaussian samples."""

    def __init__(self, low, high):
        self.low, self.high = np.asarray(low), np.asarray(high)

    def __call__(self, actions):
        a = np.clip(actions, -1.0, 1.0)
        return self.low + (a + 1.0) * 0.5 * (self.high - self.low)


class ConvertToNumpy(ActionConnector):
    """Device arrays -> host numpy before the env sees them (reference:
    action/pipeline.py ConvertToNumpyConnector)."""

    def __call__(self, actions):
        return np.asarray(actions)


class ConnectorPipeline:
    """Ordered list of connectors applied in sequence (reference:
    connectors/connector.py:320). Mutable composition (append/prepend/
    insert/remove by class name) + whole-pipeline state and serialization
    round-trips."""

    def __init__(self, connectors: list):
        self.connectors = list(connectors)

    def __call__(self, x):
        for c in self.connectors:
            x = c(x)
        return x

    def transform(self, x):
        for c in self.connectors:
            x = c.transform(x) if hasattr(c, "transform") else c(x)
        return x

    def peek(self, x):
        for c in self.connectors:
            x = c.peek(x) if hasattr(c, "peek") else c(x)
        return x

    def on_episode_done(self, done_mask):
        for c in self.connectors:
            if hasattr(c, "on_episode_done"):
                c.on_episode_done(done_mask)

    # -- composition ---------------------------------------------------------

    def append(self, connector):
        self.connectors.append(connector)
        return self

    def prepend(self, connector):
        self.connectors.insert(0, connector)
        return self

    def _index_of(self, name: str) -> int:
        for i, c in enumerate(self.connectors):
            if type(c).__name__ == name:
                return i
        raise ValueError(f"no connector named {name!r} in {self}")

    def insert_before(self, name: str, connector):
        self.connectors.insert(self._index_of(name), connector)
        return self

    def insert_after(self, name: str, connector):
        self.connectors.insert(self._index_of(name) + 1, connector)
        return self

    def remove(self, name: str):
        del self.connectors[self._index_of(name)]
        return self

    def __repr__(self):
        inner = ", ".join(type(c).__name__ for c in self.connectors)
        return f"{type(self).__name__}([{inner}])"

    # -- state & serialization ----------------------------------------------

    def get_state(self):
        return [c.get_state() if hasattr(c, "get_state") else None for c in self.connectors]

    def set_state(self, states):
        for c, st in zip(self.connectors, states):
            if st is not None and hasattr(c, "set_state"):
                c.set_state(st)

    def serialize(self) -> bytes:
        """Structure AND state in one blob: a deserialized pipeline resumes
        exactly (filters keep their running statistics, frame stacks their
        buffers). Reference: Connector.to_state/from_state."""
        import cloudpickle

        return cloudpickle.dumps({"connectors": self.connectors, "cls": type(self).__name__})

    @staticmethod
    def deserialize(blob: bytes) -> "ConnectorPipeline":
        import cloudpickle

        data = cloudpickle.loads(blob)
        cls = {c.__name__: c for c in (ConnectorPipeline, AgentConnectorPipeline, ActionConnectorPipeline)}[
            data["cls"]
        ]
        return cls(data["connectors"])


class AgentConnectorPipeline(ConnectorPipeline):
    """Observation-side pipeline (reference: agent/pipeline.py:21)."""


class ActionConnectorPipeline(ConnectorPipeline):
    """Action-side pipeline (reference: action/pipeline.py)."""
