"""RolloutWorker + WorkerSet — CPU actors stepping vectorized envs.

Reference: rllib/evaluation/rollout_worker.py:166 (RolloutWorker, sample
:666), worker_set.py:80 (WorkerSet), utils/actor_manager.py:189
(FaultTolerantActorManager — lost workers are respawned and the round
continues with the survivors). The async mode (start_async/get_async) is
the analog of AsyncSampler/EnvRunnerV2 (rllib/evaluation/sampler.py:309,
env_runner_v2.py:199): a background thread keeps stepping the vector env
into a bounded fragment queue while the learner consumes and updates —
V-trace/IS corrections in IMPALA/APPO absorb the policy staleness this
introduces.

A worker's policy forward runs on the CPU, by design: rollouts stay off the
card, as the JAX package pins its workers to the CPU platform. Weights reach
the workers as numpy trees through the object store (host weight sync). The
Podracer device path (a weight group and a device-object broadcast of packed
weights) is not ported yet: its methods raise, naming ROADMAP A13d.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
from typing import List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.core.learner import PODRACER
from ray_tpu_torch.rllib.core.rl_module import RLModule
from ray_tpu_torch.rllib.env.vector_env import make_vector_env
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    DONES,
    EPS_ID,
    LOGPS,
    OBS,
    REWARDS,
    VF_PREDS,
    SampleBatch,
    compute_gae,
)

logger = logging.getLogger(__name__)


class RolloutWorker:
    """One actor: vector env + policy forward, producing GAE-postprocessed
    SampleBatches."""

    def __init__(self, env_spec, spec, worker_index: int = 0, num_envs: int = 1,
                 env_config: Optional[dict] = None, gamma: float = 0.99,
                 lambda_: float = 0.95, seed: int = 0, observation_filter: Optional[str] = None,
                 agent_connectors=None, clip_actions: bool = True,
                 action_connectors=None):
        # make_vector_env flattens MultiAgentEnvs into per-agent slots
        # (shared-policy training, reference's default policy mapping).
        self.env = make_vector_env(env_spec, num_envs, env_config, worker_index, seed=seed + worker_index * 1000)
        # Connector pipelines (reference: rllib/connectors/connector.py:320 +
        # agent/pipeline.py:21): agent connectors shape observations before
        # the policy forward; action connectors shape sampled actions before
        # env.step. The stateful observation filter is a PIPELINE STAGE (not
        # ad hoc worker code): it runs first, user stages after. Box spaces
        # get automatic action clipping appended (the policy's gaussian
        # sample is unbounded).
        from ray_tpu_torch.rllib.connectors import (
            ActionConnectorPipeline,
            AgentConnectorPipeline,
            ClipActions,
            MeanStdFilter,
        )

        self._filter_stage = None
        self._filter_delta = None
        agent_stages = list(agent_connectors or [])
        if observation_filter in ("MeanStdFilter", "mean_std"):
            self._filter_stage = MeanStdFilter()
            # Local-only accumulation since the last sync; the driver merges
            # DELTAS (reference: FilterManager flushes buffers), because
            # re-merging full states would double-count shared history.
            self._filter_delta = MeanStdFilter()
            agent_stages.insert(0, self._filter_stage)
        self.agent_connectors = AgentConnectorPipeline(agent_stages)
        action_stages = list(action_connectors or [])
        space = getattr(self.env, "action_space", None)
        if clip_actions and space is not None and hasattr(space, "low"):
            action_stages.append(ClipActions(space.low, space.high))
        self.action_connectors = ActionConnectorPipeline(action_stages)
        # Async env-runner state (started on demand by start_async).
        self._async_thread: Optional[threading.Thread] = None
        self._async_stop: Optional[threading.Event] = None
        self._async_q: Optional[_queue.Queue] = None
        # Guards the stateful obs filter: in async mode the runner thread
        # updates it mid-sample while filter-sync RPCs (pop_filter_delta /
        # set_filter_state) run on the actor main thread.
        self._filter_lock = threading.Lock()
        # Slot multiplier (n_agents for multi-agent envs): sample() divides
        # requested steps by it so the row count an algorithm asked for via
        # train_batch_size stays agent-count-invariant.
        self._rows_per_step = max(1, self.env.num_envs // max(num_envs, 1))
        self.spec = spec
        self.gamma = gamma
        self.lambda_ = lambda_
        import torch

        # Rollouts stay off the card: the sampling forward runs on the CPU
        # on purpose, as the JAX package pins its workers to the CPU. The
        # worker holds one CPU, and its forwards are a few rows: one intra-op
        # thread (several workers' thread pools on the same cores spin
        # against each other, ~20x slower).
        torch.set_num_threads(1)
        self._module = RLModule(spec, device="cpu").requires_grad_(False)
        self._gen = torch.Generator().manual_seed(seed + worker_index)
        self._params = None

    def _sample_fn(self, obs: np.ndarray, explore: bool):
        import torch

        with torch.no_grad():
            actions, logp, value = self._module.sample_actions(torch.from_numpy(obs), self._gen, explore)
        return actions.numpy(), logp.numpy(), value.numpy()

    def set_weights(self, weights) -> bool:
        self._module.load_params(weights)
        self._params = weights
        return True

    # ---- Podracer weight sync (device-object broadcast path): ROADMAP A13d ----

    def init_collective(self, world_size: int, rank: int, backend: str = "gloo",
                        group_name: str = "rllib_weights") -> bool:
        raise NotImplementedError(PODRACER)

    def set_packed_weights(self, packed) -> bool:
        raise NotImplementedError(PODRACER)

    def _shape_obs(self, obs: np.ndarray, explore: bool, peek: bool = False) -> np.ndarray:
        """One pipeline call: while exploring, stateful stages update
        (__call__); otherwise transform-only, so learned statistics never
        absorb eval observations (temporal stages like FrameStack advance
        either way — see AgentConnector.transform). ``peek=True`` freezes
        ALL state, temporal buffers included — for bootstrap forwards over
        an obs the stepping loop will shape again (a transform there would
        double-push the fragment-boundary frame)."""
        if not self.agent_connectors.connectors:
            return obs
        with self._filter_lock:
            if peek:
                return self.agent_connectors.peek(obs)
            if self._filter_stage is not None and explore:
                self._filter_delta(obs)  # delta stats only; result unused
            return (
                self.agent_connectors(obs)
                if explore
                else self.agent_connectors.transform(obs)
            )

    def sample(self, num_steps: int, explore: bool = True) -> SampleBatch:
        """Collect `num_steps` per sub-env; GAE over each env's fragment."""
        assert self._params is not None, "set_weights before sample"
        num_steps = max(1, num_steps // self._rows_per_step)
        n_envs = self.env.num_envs
        cols: dict = {k: [] for k in (OBS, ACTIONS, REWARDS, DONES, LOGPS, VF_PREDS, EPS_ID)}
        for _ in range(num_steps):
            obs = self._shape_obs(self.env.current_obs().astype(np.float32), explore)
            actions_np, logp, value = self._sample_fn(obs, explore)
            env_actions = (
                self.action_connectors(actions_np)
                if self.action_connectors.connectors
                else actions_np
            )
            cols[OBS].append(obs)
            cols[EPS_ID].append(self.env.eps_ids())
            _, rewards, dones, _ = self.env.step(env_actions)
            # Episode boundaries reach temporal connectors (frame stacks
            # re-seed finished slots before the next episode's first obs).
            # Under the filter lock: on_episode_done mutates connector state
            # (temporal buffers), and in async mode set_connector_state /
            # set_filter_state swap that state from the actor main thread
            # mid-sample — ALL pipeline mutation serializes on one lock.
            if np.any(dones):
                with self._filter_lock:
                    self.agent_connectors.on_episode_done(dones)
            # The TRAINING batch keeps the raw sampled action: logp was
            # computed for it, and training on the clipped action would
            # bias the policy gradient at the clip boundary (reference
            # clips only on the env side for the same reason).
            cols[ACTIONS].append(actions_np)
            cols[REWARDS].append(rewards)
            cols[DONES].append(dones)
            cols[LOGPS].append(np.asarray(logp))
            cols[VF_PREDS].append(np.asarray(value))
        # Bootstrap value for the final obs of each env (peek: the next
        # fragment shapes this same obs as its first step).
        final_obs = self._shape_obs(self.env.current_obs().astype(np.float32), False, peek=True)
        _, _, last_values = self._sample_fn(final_obs, False)
        # [T, N, ...] -> per-env fragments -> GAE -> concat.
        frags = []
        for e in range(n_envs):
            frag = SampleBatch({k: np.stack([step[e] for step in v]) for k, v in cols.items()})
            frag = compute_gae(frag, last_values[e], self.gamma, self.lambda_)
            frags.append(frag)
        batch = SampleBatch.concat_samples(frags)
        return batch

    # -- async env-runner (reference: AsyncSampler sampler.py:309 /
    # EnvRunnerV2 env_runner_v2.py:199) ---------------------------------
    def start_async(self, fragment_len: int, queue_size: int = 4) -> bool:
        """Launch the background fragment producer: steps the vector env
        continuously with the latest weights, queueing GAE-postprocessed
        fragments. The bounded queue gives backpressure — when the learner
        lags, the producer blocks instead of growing stale sample memory."""
        if self._async_thread is not None:
            if self._async_thread.is_alive():
                return True
            # Previous runner finished dying after a timed-out stop_async;
            # safe to replace it now.
            self._async_thread = None
        q = _queue.Queue(maxsize=queue_size)
        stop = threading.Event()
        self._async_q = q
        self._async_stop = stop
        self._async_thread = threading.Thread(
            target=self._async_loop, args=(fragment_len, q, stop), daemon=True,
            name="env-runner",
        )
        self._async_thread.start()
        return True

    def _async_loop(self, fragment_len: int, q: "_queue.Queue", stop: threading.Event):
        # q/stop are captured locals: stop_async may null the instance
        # attributes while this thread is mid-fragment.
        import time as _time

        while not stop.is_set():
            if self._params is None:
                _time.sleep(0.02)
                continue
            try:
                batch = self.sample(fragment_len, explore=True)
            except Exception:
                logger.exception("async env-runner sampling failed")
                _time.sleep(0.5)
                continue
            rewards, lens = self.env.pop_episode_stats()
            item = {"batch": batch, "episode_rewards": rewards, "episode_lens": lens}
            # Blocking put = backpressure; wake periodically to honor stop.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.25)
                    break
                except _queue.Full:
                    continue

    def get_async(self, max_items: int = 8, timeout: float = 10.0) -> list:
        """Drain ready fragments (blocking for at least one, up to timeout).
        Returns [] when the runner isn't started or nothing arrived."""
        if self._async_q is None:
            return []
        items = []
        try:
            items.append(self._async_q.get(timeout=timeout))
        except _queue.Empty:
            return []
        while len(items) < max_items:
            try:
                items.append(self._async_q.get_nowait())
            except _queue.Empty:
                break
        return items

    def async_queue_depth(self) -> int:
        return -1 if self._async_q is None else self._async_q.qsize()

    def stop_async(self) -> bool:
        if self._async_thread is None:
            return False
        self._async_stop.set()
        # Unblock a producer stuck on a full queue.
        try:
            while True:
                self._async_q.get_nowait()
        except _queue.Empty:
            pass
        self._async_thread.join(timeout=10)
        if self._async_thread.is_alive():
            # Mid-fragment on a slow env: leave the fields in place so
            # start_async won't spawn a SECOND runner over the same env —
            # the stop event is set, so this one exits after its fragment.
            logger.warning("async env-runner still draining; restart deferred")
            return False
        self._async_thread = None
        self._async_q = None
        return True

    def episode_stats(self) -> dict:
        rewards, lens = self.env.pop_episode_stats()
        return {"episode_rewards": rewards, "episode_lens": lens}

    def get_filter_state(self):
        return self._filter_stage.get_state() if self._filter_stage is not None else None

    def pop_filter_delta(self):
        """Return accumulation since the last sync and reset it."""
        if self._filter_delta is None:
            return None
        from ray_tpu_torch.rllib.connectors import MeanStdFilter

        with self._filter_lock:
            state = self._filter_delta.get_state()
            self._filter_delta = MeanStdFilter()
        return state

    def set_filter_state(self, state) -> bool:
        if self._filter_stage is not None and state is not None:
            with self._filter_lock:
                self._filter_stage.set_state(state)
        return True

    def get_connector_state(self) -> dict:
        """Serialized agent+action pipelines (structure AND state) — what a
        checkpoint carries so a restored worker resumes filters/stacks."""
        with self._filter_lock:
            return {
                "agent": self.agent_connectors.serialize(),
                "action": self.action_connectors.serialize(),
            }

    def set_connector_state(self, blobs: dict) -> bool:
        from ray_tpu_torch.rllib.connectors import ConnectorPipeline, MeanStdFilter

        with self._filter_lock:
            self.agent_connectors = ConnectorPipeline.deserialize(blobs["agent"])
            self.action_connectors = ConnectorPipeline.deserialize(blobs["action"])
            self._filter_stage = next(
                (c for c in self.agent_connectors.connectors if isinstance(c, MeanStdFilter)),
                None,
            )
            # Keep the delta accumulator consistent with the restored
            # pipeline: a worker built filterless gains one, a worker whose
            # restored pipeline dropped the filter must stop accumulating.
            self._filter_delta = MeanStdFilter() if self._filter_stage is not None else None
        return True

    def ping(self) -> bool:
        return True

    def stop(self):
        self.env.close()
        return True


class WorkerSet:
    """Fault-tolerant gang of rollout workers (reference: worker_set.py:80 +
    FaultTolerantActorManager)."""

    def __init__(self, env_spec, spec, *, num_workers: int, num_envs_per_worker: int = 1,
                 env_config: Optional[dict] = None, gamma: float = 0.99, lambda_: float = 0.95,
                 seed: int = 0, num_cpus_per_worker: float = 1,
                 observation_filter: Optional[str] = None, agent_connectors=None,
                 clip_actions: bool = True, recreate_failed_workers: bool = True,
                 max_worker_restarts: int = 100, action_connectors=None):
        self.observation_filter = observation_filter
        # Failure policy (reference: AlgorithmConfig.fault_tolerance()):
        # respawn dead workers while the restart budget lasts; afterwards
        # (or with recreate_failed_workers=False) degrade to the survivors.
        self.recreate_failed_workers = recreate_failed_workers
        self.max_worker_restarts = max_worker_restarts
        self._restarts = 0
        self._filter_base = None  # merged filter history (driver-side)
        self._make_worker = lambda idx: ray_tpu_torch.remote(num_cpus=num_cpus_per_worker)(RolloutWorker).remote(
            env_spec, spec, idx, num_envs_per_worker, env_config, gamma, lambda_, seed,
            observation_filter, agent_connectors, clip_actions, action_connectors
        )
        self._workers = [self._make_worker(i + 1) for i in range(num_workers)]
        self._indices = list(range(1, num_workers + 1))
        # Async env-runner mode (None = sync). Set by start_async; replaced
        # workers are restarted into the same mode.
        self._async_fragment_len: Optional[int] = None
        self._pending_stats = {"episode_rewards": [], "episode_lens": []}

    @property
    def num_workers(self) -> int:
        return len(self._workers)

    def _replace_worker(self, pos: int):
        """Respawn the worker at list position `pos`. The old actor MUST be
        killed first: a merely-slow actor that we abandoned would keep its
        CPU reservation forever and starve future creations. When the
        restart budget is spent (or recreation is disabled), the dead
        worker is dropped instead and the set degrades — unless it was the
        LAST one, where degrading means silently training on nothing."""
        old = self._workers[pos]
        try:
            ray_tpu_torch.kill(old)
        except Exception:
            pass
        if (not self.recreate_failed_workers or self._restarts >= self.max_worker_restarts):
            if len(self._workers) <= 1:
                raise RuntimeError(
                    "last rollout worker died and the restart budget is spent "
                    f"(restarts={self._restarts}, recreate={self.recreate_failed_workers})"
                )
            logger.warning(
                "dropping dead rollout worker %d (restarts=%d, budget=%d)",
                self._indices[pos], self._restarts, self.max_worker_restarts,
            )
            del self._workers[pos]
            del self._indices[pos]
            return None
        self._restarts += 1
        self._workers[pos] = self._make_worker(self._indices[pos])
        if self._async_fragment_len is not None:
            # Restarted into async mode; its runner idles until the next
            # weight broadcast delivers params.
            try:
                self._workers[pos].start_async.remote(self._async_fragment_len)
            except Exception:
                pass
        return self._workers[pos]

    def _replace_by_identity(self, w):
        """_replace_worker keyed by actor handle (safe across drops that
        shift positional indices)."""
        try:
            return self._replace_worker(self._workers.index(w))
        except ValueError:
            return None

    def sync_weights(self, weights):
        self._sync_weights_via(lambda w: w.set_weights.remote(weights))

    def sync_packed_weights(self, ref):
        raise NotImplementedError(PODRACER)

    def _sync_weights_via(self, submit):
        """Shared fault-tolerant sync loop: a dead worker is respawned and
        fed the same weights before the round completes."""
        for w in list(self._workers):
            try:
                ray_tpu_torch.get(submit(w), timeout=120)
            except Exception:
                # Position by identity: a drop earlier in this loop shifts
                # positional indices.
                try:
                    pos = self._workers.index(w)
                except ValueError:
                    continue
                logger.warning("sync_weights: worker %d dead; respawning", self._indices[pos])
                replacement = self._replace_worker(pos)
                if replacement is not None:
                    ray_tpu_torch.get(submit(replacement), timeout=120)

    def init_weight_group(self, group_name: str, *, backend: str = "gloo",
                          world_size: int | None = None, base_rank: int = 1):
        raise NotImplementedError(PODRACER)

    def resize(self, num_workers: int) -> int:
        """Grow or shrink the sampler fleet mid-training. Growing spawns
        workers at fresh worker indices; shrinking stops and kills the tail
        workers. New workers have no params until the next weight sync —
        callers should sync immediately after a grow. Returns the new worker
        count."""
        target = int(num_workers)
        if target < 1:
            raise ValueError("resize needs at least one rollout worker")
        if target == len(self._workers):
            return target
        if target < len(self._workers):
            victims = self._workers[target:]
            for w in victims:
                try:
                    w.stop.remote()
                except Exception:
                    pass
            for w in victims:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:
                    pass
            del self._workers[target:]
            del self._indices[target:]
            logger.info("worker set shrunk to %d samplers", target)
            return target
        # Grow: fresh worker indices (never reuse — env seeds derive from
        # them).
        next_idx = max(self._indices, default=0) + 1
        new_positions = []
        while len(self._workers) < target:
            self._workers.append(self._make_worker(next_idx))
            self._indices.append(next_idx)
            new_positions.append(len(self._workers) - 1)
            next_idx += 1
        if self._async_fragment_len is not None:
            for pos in new_positions:
                try:
                    self._workers[pos].start_async.remote(self._async_fragment_len)
                except Exception:
                    pass
        logger.info("worker set grown to %d samplers", target)
        return target

    def ensure_registered(self):
        raise NotImplementedError(PODRACER)

    def sample(self, steps_per_worker: int, explore: bool = True) -> List[SampleBatch]:
        """Synchronous parallel sampling with fault tolerance: a worker that
        dies mid-round is replaced and the round proceeds without it
        (reference: execution/rollout_ops.py:21 + actor_manager probe).
        ``explore=False`` samples greedily (evaluation rollouts)."""
        refs: dict = {}
        results: List[SampleBatch] = []
        dead: list = []
        for i, w in zip(self._indices, self._workers):
            try:
                refs[w.sample.remote(steps_per_worker, explore)] = (i, w)
            except Exception:
                logger.warning("rollout worker %d unreachable at submit; respawning", i)
                dead.append((i, w))
        for ref, (idx, w) in refs.items():
            try:
                results.append(ray_tpu_torch.get(ref, timeout=300))
            except Exception:
                logger.warning("rollout worker %d failed; respawning", idx)
                dead.append((idx, w))
        for idx, w in dead:
            self._replace_by_identity(w)
        return results

    # -- async env-runner orchestration (reference: AsyncSampler) --------
    @property
    def is_async(self) -> bool:
        return self._async_fragment_len is not None

    def start_async(self, fragment_len: int):
        """Flip every worker into continuous background sampling."""
        self._async_fragment_len = fragment_len
        refs = [w.start_async.remote(fragment_len) for w in self._workers]
        for ref in refs:
            try:
                ray_tpu_torch.get(ref, timeout=60)
            except Exception:
                pass  # dead worker surfaces at the next gather

    def sample_async(self, min_steps: int, timeout: float = 60.0) -> List[SampleBatch]:
        """Gather fragments from the background runners until ``min_steps``
        rows arrive (or timeout). Episode stats ride with the fragments —
        they are accumulated here and served by episode_stats(), because in
        async mode the env belongs to the runner thread."""
        import time as _time

        assert self._async_fragment_len is not None, "start_async first"
        batches: List[SampleBatch] = []
        total = 0
        deadline = _time.monotonic() + timeout
        while total < min_steps and _time.monotonic() < deadline:
            refs = {}
            for w in list(self._workers):
                try:
                    refs[w.get_async.remote(timeout=5.0)] = w
                except Exception:
                    self._replace_by_identity(w)
            for ref, w in refs.items():
                try:
                    items = ray_tpu_torch.get(ref, timeout=120)
                except Exception:
                    logger.warning("async rollout worker failed; respawning")
                    self._replace_by_identity(w)
                    continue
                for item in items:
                    batches.append(item["batch"])
                    total += len(item["batch"])
                    self._pending_stats["episode_rewards"] += item["episode_rewards"]
                    self._pending_stats["episode_lens"] += item["episode_lens"]
        return batches

    def stop_async(self):
        if self._async_fragment_len is None:
            return
        self._async_fragment_len = None
        for w in self._workers:
            try:
                w.stop_async.remote()
            except Exception:
                pass

    def sync_filters(self):
        """Merge per-worker filter DELTAS into the shared base and
        redistribute (reference: FilterManager.synchronize — deltas, not full
        states, so shared history is never double-counted)."""
        if not self.observation_filter or not self._workers:
            return
        from ray_tpu_torch.rllib.connectors import MeanStdFilter

        # Fan out, then gather (a slow worker must not serialize the sync).
        pop_refs = [w.pop_filter_delta.remote() for w in self._workers]
        deltas = []
        for ref in pop_refs:
            try:
                deltas.append(ray_tpu_torch.get(ref, timeout=60))
            except Exception:
                pass
        merger = MeanStdFilter()
        states = [self._filter_base] + [d for d in deltas if d]
        merger.merge_states([st for st in states if st])
        self._filter_base = merger.get_state()
        set_refs = [w.set_filter_state.remote(self._filter_base) for w in self._workers]
        for ref in set_refs:
            try:
                ray_tpu_torch.get(ref, timeout=60)
            except Exception:
                pass

    def episode_stats(self) -> dict:
        if self._async_fragment_len is not None:
            # Async mode: the env belongs to the runner thread, so stats
            # travel WITH the fragments and were accumulated by
            # sample_async — polling the workers would race the runner.
            stats, self._pending_stats = self._pending_stats, {
                "episode_rewards": [], "episode_lens": [],
            }
            return stats
        stats = {"episode_rewards": [], "episode_lens": []}
        for ref in [w.episode_stats.remote() for w in self._workers]:
            try:
                s = ray_tpu_torch.get(ref, timeout=60)
                stats["episode_rewards"] += s["episode_rewards"]
                stats["episode_lens"] += s["episode_lens"]
            except Exception:
                pass
        return stats

    def stop(self):
        for w in self._workers:
            try:
                w.stop.remote()
            except Exception:
                pass
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)  # release the actor's CPU hold
            except Exception:
                pass
        self._workers = []
