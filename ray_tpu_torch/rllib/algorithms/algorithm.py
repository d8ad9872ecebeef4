"""Algorithm — the RLlib trainer base, a Tune Trainable.

Reference: rllib/algorithms/algorithm.py:149 (Algorithm extends Trainable,
setup :510 builds WorkerSet + LearnerGroup, training_step :1347) and
algorithm_config.py (fluent AlgorithmConfig builder).

The learner runs on ``AlgorithmConfig.resources(device=...)``, the card by
default (``device='cpu'`` asks for the CPU); rollout workers run on the CPU.
Weights reach the workers through the object store (host sync), or, with
``weight_sync="device_broadcast"`` (the Podracer topology), as one packed
vector that the learner holds on its device and broadcasts over the
learner<->sampler weight group (the host plane, never NCCL: the samplers hold
no card).
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Optional, Type

import numpy as np

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.evaluation.rollout_worker import WorkerSet
from ray_tpu_torch.tune.trainable import Trainable

# Weight-group names are per-process singletons: each Algorithm suffixes the
# configured name with its own number, so two live Algorithms in one driver
# never share a group.
_WEIGHT_GROUP_SEQ = itertools.count(1)


@contextlib.contextmanager
def probe_env(cfg):
    """A probe of ``cfg.env`` (an id through the port's ``make``, or the
    env class called with ``cfg.env_config``) for reading its spaces, closed
    on exit."""
    from ray_tpu_torch.rllib.env.cartpole import make

    probe = make(cfg.env) if isinstance(cfg.env, str) else cfg.env(dict(cfg.env_config))
    try:
        yield probe
    finally:
        probe.close()


class AlgorithmConfig:
    """Fluent config builder (reference: algorithm_config.py)."""

    def __init__(self, algo_class: Optional[Type["Algorithm"]] = None):
        self.algo_class = algo_class
        self.env = None
        self.env_config: dict = {}
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 1
        self.rollout_fragment_length = 200
        self.observation_filter: Optional[str] = None
        # Connector pipelines (reference: .env_runners(env_to_module_connector)
        # / legacy agent+action connectors): lists of stage instances shipped
        # to every rollout AND eval worker.
        self.agent_connectors: Optional[list] = None
        self.action_connectors: Optional[list] = None
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.lr = 5e-5
        self.train_batch_size = 4000
        self.grad_clip: Optional[float] = None
        # Weight-sync transport (Podracer topology, arXiv:2104.06272):
        # "host" ships the params tree through the object store per worker;
        # "device_broadcast" fans one device-resident vector to the sampler
        # fleet with device_object.broadcast over the weight group, whose
        # backend is the host plane ("cpu").
        self.weight_sync = "host"
        self.weight_sync_group = "rllib_weights"
        self.weight_sync_backend = "cpu"
        # Gradient-sync transport for multi-learner data parallelism:
        # "host" allreduces each gradient through the collective group;
        # "device_allreduce" sends one packed vector through the relay tree.
        self.grad_sync = "host"
        # Podracer learner mesh: on one device the same update; over more
        # than one rank, ROADMAP A9f.
        self.learner_mesh = False
        self.model_hiddens = (64, 64)
        self.model_conv_filters = None  # [(out_ch, kernel, stride), ...] for image obs
        self.seed = 0
        self.num_learners = 0
        self.num_gpus_per_learner = 0.0
        # Where the learner (and compute_single_action) runs: the card unless
        # the config asks for the CPU.
        self.device = "cuda"
        self.explore = True
        # Evaluation (reference: algorithm_config.py:383 .evaluation()):
        # None = never evaluate; N = every N training iterations.
        self.evaluation_interval: Optional[int] = None
        self.evaluation_num_workers = 1
        self.evaluation_duration = 10
        self.evaluation_duration_unit = "episodes"  # or "timesteps"
        # Fault tolerance (reference: algorithm_config.py .fault_tolerance()):
        # dead rollout workers are respawned up to max_worker_restarts times
        # total; with recreate_failed_workers=False the set degrades instead.
        self.recreate_failed_workers = True
        self.max_worker_restarts = 100
        # Reporting (reference: .reporting()):
        self.metrics_num_episodes_for_smoothing = 100
        self.min_time_s_per_iteration: Optional[float] = None
        # Offline data (reference: .offline_data()); consumed by the offline
        # families (MARWIL/BC/CQL/CRR/DT) which override these defaults.
        self.input_ = None
        self.output = None
        self.input_reader_kwargs: dict = {}
        # Callbacks class (reference: .callbacks()).
        self.callbacks_class = None
        self.extra: dict = {}

    # -- fluent sections (reference: .environment/.rollouts/.training) ----
    def environment(self, env=None, *, env_config: Optional[dict] = None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = env_config
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None, num_envs_per_worker: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None,
                 observation_filter: Optional[str] = None,
                 agent_connectors: Optional[list] = None,
                 action_connectors: Optional[list] = None) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if observation_filter is not None:
            self.observation_filter = observation_filter
        if agent_connectors is not None:
            self.agent_connectors = list(agent_connectors)
        if action_connectors is not None:
            self.action_connectors = list(action_connectors)
        return self

    def training(self, *, lr: Optional[float] = None, gamma: Optional[float] = None,
                 train_batch_size: Optional[int] = None, grad_clip: Optional[float] = None,
                 model_hiddens=None, model_conv_filters=None,
                 weight_sync: Optional[str] = None,
                 weight_sync_backend: Optional[str] = None,
                 grad_sync: Optional[str] = None,
                 learner_mesh: Optional[bool] = None, **extra) -> "AlgorithmConfig":
        if lr is not None:
            self.lr = lr
        if gamma is not None:
            self.gamma = gamma
        if train_batch_size is not None:
            self.train_batch_size = train_batch_size
        if grad_clip is not None:
            self.grad_clip = grad_clip
        if weight_sync is not None:
            assert weight_sync in ("host", "device_broadcast"), weight_sync
            self.weight_sync = weight_sync
        if weight_sync_backend is not None:
            if weight_sync_backend == "nccl":
                raise ValueError("the weight group spans the CPU samplers: its backend is the host plane "
                                 "('cpu'), never NCCL")
            self.weight_sync_backend = weight_sync_backend
        if grad_sync is not None:
            assert grad_sync in ("host", "device_allreduce"), grad_sync
            self.grad_sync = grad_sync
        if learner_mesh is not None:
            self.learner_mesh = learner_mesh
        if model_hiddens is not None:
            self.model_hiddens = tuple(model_hiddens)
        if model_conv_filters is not None:
            self.model_conv_filters = tuple(tuple(f) for f in model_conv_filters)
        self.extra.update(extra)
        return self

    def resources(self, *, num_learners: Optional[int] = None, num_gpus_per_learner: Optional[float] = None,
                  device: Optional[str] = None) -> "AlgorithmConfig":
        """Learner placement: ``num_learners`` = 0 runs the learner in this
        process, > 0 in that many actors, each holding
        ``num_gpus_per_learner`` of the runtime's GPU resource; ``device`` is
        where they compute (the card, or ``"cpu"``)."""
        if num_learners is not None:
            self.num_learners = num_learners
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = num_gpus_per_learner
        if device is not None:
            self.device = device
        return self

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_num_workers: Optional[int] = None,
                   evaluation_duration: Optional[int] = None,
                   evaluation_duration_unit: Optional[str] = None) -> "AlgorithmConfig":
        """Dedicated greedy evaluation every ``evaluation_interval`` training
        iterations (reference: algorithm_config.py:383). Eval rollouts use
        explore=False on a separate worker set (or a driver-local env for
        algorithms without the standard rollout stack) so exploration noise
        and training episode stats are never mixed into eval metrics."""
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_num_workers is not None:
            self.evaluation_num_workers = evaluation_num_workers
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        if evaluation_duration_unit is not None:
            assert evaluation_duration_unit in ("episodes", "timesteps")
            self.evaluation_duration_unit = evaluation_duration_unit
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def exploration(self, *, explore: Optional[bool] = None,
                    exploration_config: Optional[dict] = None) -> "AlgorithmConfig":
        """Exploration switches (reference: algorithm_config.py
        .exploration()). ``explore`` gates stochastic action sampling at
        compute-action time; ``exploration_config`` entries land on the
        algorithm config's matching attributes (epsilon schedules for the
        Q-family, noise scales for the deterministic-policy family — each
        algo config declares its own)."""
        if explore is not None:
            self.explore = explore
        if exploration_config:
            self.update_from_dict(dict(exploration_config))
        return self

    def fault_tolerance(self, *, recreate_failed_workers: Optional[bool] = None,
                        max_worker_restarts: Optional[int] = None) -> "AlgorithmConfig":
        """Rollout-worker failure policy (reference: .fault_tolerance()):
        respawn dead workers (WorkerSet._replace_worker) up to a budget, or
        degrade to the survivors."""
        if recreate_failed_workers is not None:
            self.recreate_failed_workers = recreate_failed_workers
        if max_worker_restarts is not None:
            self.max_worker_restarts = max_worker_restarts
        return self

    def reporting(self, *, metrics_num_episodes_for_smoothing: Optional[int] = None,
                  min_time_s_per_iteration: Optional[float] = None) -> "AlgorithmConfig":
        """Result-shaping knobs (reference: .reporting()):
        episode_reward_mean smoothing window and a minimum wall-clock per
        train() iteration (step() keeps running training_steps until it is
        reached — the reference's min_time_s_per_iteration semantics)."""
        if metrics_num_episodes_for_smoothing is not None:
            self.metrics_num_episodes_for_smoothing = metrics_num_episodes_for_smoothing
        if min_time_s_per_iteration is not None:
            self.min_time_s_per_iteration = min_time_s_per_iteration
        return self

    def offline_data(
        self, *, input_=None, output=None, input_reader_kwargs=None
    ) -> "AlgorithmConfig":
        """Offline dataset source/sink (reference: .offline_data()). The
        offline families consume ``input_`` (path/glob/list/Dataset/live
        PolicyServerInput); online families may set ``output`` to log
        rollouts (JSON writer). ``input_reader_kwargs`` reach the
        constructed reader (e.g. timeout_s/min_episodes/window_rows for
        slow external simulators)."""
        if input_ is not None:
            self.input_ = input_
        if output is not None:
            self.output = output
        if input_reader_kwargs is not None:
            self.input_reader_kwargs = dict(input_reader_kwargs)
        return self

    def callbacks(self, callbacks_class) -> "AlgorithmConfig":
        """Attach a DefaultCallbacks subclass (reference: .callbacks())."""
        self.callbacks_class = callbacks_class
        return self

    def framework(self, framework: Optional[str] = None, **_ignored) -> "AlgorithmConfig":
        """Parity shim: this stack is torch; "torch" (or None) is the only
        accepted value — naming another framework here is a porting bug we
        surface loudly instead of silently training something else."""
        if framework not in (None, "torch"):
            raise ValueError(
                f"framework {framework!r} unavailable: ray_tpu_torch.rllib runs on torch"
            )
        return self

    def update_from_dict(self, overrides: dict) -> "AlgorithmConfig":
        """Apply {attr: value} overrides; unknown keys land in .extra
        (shared by the CLI, tuned-example runner, and __init__)."""
        for key, value in (overrides or {}).items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                self.extra[key] = value
        return self

    def model_config(self) -> dict:
        """Catalog-shaped model config (reference: config.model dict)."""
        return {
            "fcnet_hiddens": self.model_hiddens,
            "conv_filters": self.model_conv_filters,
        }

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    def build(self) -> "Algorithm":
        assert self.algo_class is not None, "config not bound to an algorithm"
        return self.algo_class(config=self)


class Algorithm(Trainable):
    """Extends the Tune Trainable so `tune.Tuner(PPO, ...)` works the same
    way as the reference (§3.6 of the survey)."""

    _config_class = AlgorithmConfig

    def __init__(self, config=None, **kwargs):
        if isinstance(config, AlgorithmConfig):
            self._algo_config = config
        else:
            self._algo_config = self.get_default_config().update_from_dict(config or {})
        from ray_tpu_torch.rllib.callbacks import make_callbacks

        self.callbacks = make_callbacks(getattr(self._algo_config, "callbacks_class", None))
        super().__init__(config=self._algo_config.to_dict())
        # Trainable.__init__ ran setup(); the algorithm is live now.
        self.callbacks.on_algorithm_init(algorithm=self)

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return AlgorithmConfig(algo_class=cls)

    # -- Trainable protocol -------------------------------------------------
    def setup(self, config: dict) -> None:
        # Trainable.__init__ already ran setup; a second explicit setup()
        # (common in user code and tests) must not orphan the first worker
        # set — leaked rollout actors hold CPU reservations forever.
        existing = getattr(self, "workers", None)
        if existing is not None:
            existing.stop()
        existing_eval = getattr(self, "_eval_workers", None)
        if existing_eval is not None:
            existing_eval.stop()
            self._eval_workers = None
        existing_lg = getattr(self, "learner_group", None)
        if existing_lg is not None and hasattr(existing_lg, "stop"):
            existing_lg.stop()
        cfg = self._algo_config
        from ray_tpu_torch.rllib.core.rl_module import _device

        _device(cfg.device)  # no card and no device="cpu": raise before any worker starts
        self.module_spec = self._spec_from_env(cfg)
        self.workers = WorkerSet(
            cfg.env,
            self.module_spec,
            num_workers=cfg.num_rollout_workers,
            num_envs_per_worker=cfg.num_envs_per_worker,
            env_config=cfg.env_config,
            gamma=cfg.gamma,
            lambda_=cfg.lambda_,
            seed=cfg.seed,
            observation_filter=getattr(cfg, "observation_filter", None),
            agent_connectors=getattr(cfg, "agent_connectors", None),
            action_connectors=getattr(cfg, "action_connectors", None),
            recreate_failed_workers=getattr(cfg, "recreate_failed_workers", True),
            max_worker_restarts=getattr(cfg, "max_worker_restarts", 100),
        )
        self.learner_group = self._build_learner_group(cfg)
        self._act_module = None
        self._device_sync_ready = False
        if getattr(cfg, "weight_sync", "host") == "device_broadcast":
            try:
                self._setup_device_weight_sync(cfg)
            except Exception:
                self.cleanup()  # the actors' reservations go before the error does
                raise
        self.sync_worker_weights()
        self._episode_reward_window: list = []
        self._timesteps_total = 0

    @staticmethod
    def _spec_from_env(cfg: AlgorithmConfig):
        """The RLModuleSpec for ``cfg.env``'s spaces and ``cfg``'s model
        config, from the probe env."""
        from ray_tpu_torch.rllib.models import ModelCatalog

        with probe_env(cfg) as probe:
            return ModelCatalog.get_model_spec(probe.observation_space, probe.action_space, cfg.model_config())

    def _setup_device_weight_sync(self, cfg) -> None:
        """Form the learner<->sampler weight group (Podracer topology): the
        learner is rank 0 (the holder the broadcast fans out from), the
        samplers ranks 1..N. A failure raises: the config asked for the
        device path, and no sync quietly takes the host path instead."""
        from ray_tpu_torch.util import collective

        group = self._weight_group = f"{cfg.weight_sync_group}-{next(_WEIGHT_GROUP_SEQ)}"
        backend = getattr(cfg, "weight_sync_backend", "cpu")
        world = 1 + self.workers.num_workers
        collective.destroy_collective_group(group)  # a re-setup of this instance may hold the name
        self.learner_group.init_weight_collective(world, 0, backend, group)
        self.workers.init_weight_group(group, backend=backend, world_size=world, base_rank=1)
        self._device_sync_ready = True

    def sync_worker_weights(self):
        """One weight sync, on the transport the config picked. Host: the
        learner's weights (a numpy tree) to every worker through the object
        store. Device: ONE group broadcast of the packed vector the learner
        holds (serialised once), then every worker resolves it from its inbox.
        ``strict=False``: a dead sampler is the sync loop's business (it
        respawns the worker, which re-registers at its old rank); a member
        that missed the broadcast pulls, and its ``host_sync_fallbacks``
        count says so."""
        if getattr(self, "_device_sync_ready", False):
            from ray_tpu_torch.experimental import device_object

            # Self-heal the roster first: a live sampler a prior broadcast
            # evicted on a stall re-joins, so this broadcast covers it.
            self.workers.ensure_registered()
            ref = self.learner_group.pack_weight_ref()
            device_object.broadcast(ref, self._weight_group, strict=False)
            self.workers.sync_packed_weights(ref)
            return
        self.workers.sync_weights(self.learner_group.get_weights())

    def resize_workers(self, num_workers: int) -> int:
        """Grow or shrink the sampler fleet mid-training, then sync weights
        at once so grown workers can sample. On the device path, growing
        joins the new samplers at fresh tail ranks and shrinking evicts the
        tail from the roster: the weight group is never re-formed. Returns
        the new worker count."""
        n = self.workers.resize(num_workers)
        self.sync_worker_weights()
        if getattr(self._algo_config, "observation_filter", None):
            # Grown workers start with empty filter stats; hand them the
            # merged base so their first fragments are normalized like the
            # rest of the fleet's.
            self.workers.sync_filters()
        return n

    # -- evaluation (reference: Algorithm.evaluate, algorithm.py:850) ------
    @property
    def eval_workers(self):
        """Dedicated evaluation WorkerSet, built lazily on first use so
        algorithms that never evaluate pay nothing (reference: setup builds
        evaluation_workers only when evaluation_interval is set)."""
        ws = getattr(self, "_eval_workers", None)
        if ws is None:
            cfg = self._algo_config
            ws = WorkerSet(
                cfg.env,
                self.module_spec,
                num_workers=max(1, cfg.evaluation_num_workers),
                num_envs_per_worker=cfg.num_envs_per_worker,
                env_config=cfg.env_config,
                gamma=cfg.gamma,
                lambda_=cfg.lambda_,
                # Offset so eval envs never mirror training-env seeds.
                seed=cfg.seed + 100_000,
                observation_filter=getattr(cfg, "observation_filter", None),
                # Eval samples through the SAME pipelines as training
                # (transform-only for stateful stages; reference: eval
                # workers share connector config).
                agent_connectors=getattr(cfg, "agent_connectors", None),
                action_connectors=getattr(cfg, "action_connectors", None),
            )
            self._eval_workers = ws
        return ws

    def _has_rollout_stack(self) -> bool:
        """True when this algorithm uses the standard WorkerSet+LearnerGroup
        stack (base setup); custom-stack algorithms evaluate driver-locally
        through their compute_single_action."""
        return (
            getattr(self, "learner_group", None) is not None
            and isinstance(getattr(self, "workers", None), WorkerSet)
            and getattr(self, "module_spec", None) is not None
        )

    def evaluate(self) -> dict:
        """Run one evaluation round with explore=False and return
        ``{"evaluation": {...metrics...}}``. Eval rollouts happen on a
        dedicated worker set (or a driver-local env for custom-stack
        algorithms), so exploration noise and training episode stats never
        leak into the reported numbers."""
        cfg = self._algo_config
        duration = int(cfg.evaluation_duration)
        by_episodes = cfg.evaluation_duration_unit != "timesteps"
        if self._has_rollout_stack():
            rewards, lens = self._evaluate_with_workers(duration, by_episodes)
        else:
            rewards, lens = self._evaluate_local(duration, by_episodes)
        metrics = {
            "episode_reward_mean": float(np.mean(rewards)) if rewards else float("nan"),
            "episode_reward_min": float(np.min(rewards)) if rewards else float("nan"),
            "episode_reward_max": float(np.max(rewards)) if rewards else float("nan"),
            "episode_len_mean": float(np.mean(lens)) if lens else float("nan"),
            "episodes_this_iter": len(rewards),
        }
        return {"evaluation": metrics}

    def _evaluate_with_workers(self, duration: int, by_episodes: bool):
        ws = self.eval_workers
        ws.sync_weights(self.get_policy_weights())
        if getattr(ws, "observation_filter", None):
            # Eval policies must see the same filtered observations as
            # training; copy the training filter base across.
            ws._filter_base = getattr(self.workers, "_filter_base", None)
            ws.sync_filters()
        rewards: list = []
        lens: list = []
        steps = 0
        fragment = max(16, self._algo_config.rollout_fragment_length)
        # Cap rounds so an env that never terminates can't spin forever.
        for _ in range(64):
            batches = ws.sample(fragment, explore=False)
            steps += sum(len(b) for b in batches)
            stats = ws.episode_stats()
            rewards += stats["episode_rewards"]
            lens += stats["episode_lens"]
            if (by_episodes and len(rewards) >= duration) or (
                not by_episodes and steps >= duration
            ):
                break
        return rewards, lens

    def _make_eval_env(self):
        """Fresh driver-local env for one evaluation round. Created per
        evaluate() call and closed right after (cheap for gym envs) —
        caching it would leak through the custom-stack algorithms' cleanup
        overrides and go stale across re-setup with a new env config."""
        from ray_tpu_torch.rllib.env.cartpole import make

        cfg = self._algo_config
        return (
            make(cfg.env)
            if isinstance(cfg.env, str)
            else cfg.env(dict(cfg.env_config))
        )

    def _evaluate_local(self, duration: int, by_episodes: bool):
        """Greedy episodes on a driver-local env via compute_single_action
        (used by algorithms with custom learner stacks — DQN family, ES/ARS,
        offline algos — which all expose compute_single_action)."""
        env = self._make_eval_env()
        rewards: list = []
        lens: list = []
        steps = 0
        budget = duration if by_episodes else 64
        try:
            for _ in range(budget):
                obs, _ = env.reset()
                total, length = 0.0, 0
                for _ in range(10_000):
                    action = self.compute_single_action(obs, explore=False)
                    obs, r, terminated, truncated, _ = env.step(action)
                    total += float(r)
                    length += 1
                    steps += 1
                    if terminated or truncated:
                        break
                    if not by_episodes and steps >= duration:
                        break
                rewards.append(total)
                lens.append(length)
                if not by_episodes and steps >= duration:
                    break
        finally:
            try:
                env.close()
            except Exception:
                pass
        return rewards, lens

    def train(self) -> dict:
        """One training iteration + (when due) an evaluation round attached
        under result["evaluation"] (reference: Algorithm.step wiring
        evaluate() by evaluation_interval), then the on_train_result
        callback (which may mutate the result in place)."""
        result = super().train()
        interval = getattr(self._algo_config, "evaluation_interval", None)
        if interval and self.iteration % int(interval) == 0:
            result.update(self.evaluate())
            self.callbacks.on_evaluate_end(
                algorithm=self, evaluation_metrics=result.get("evaluation", {})
            )
        self.callbacks.on_train_result(algorithm=self, result=result)
        return result

    def _build_learner_group(self, cfg: AlgorithmConfig) -> LearnerGroup:
        raise NotImplementedError

    def _gather_rollouts(self, train_batch_size: int, async_sampling: bool = False):
        """Shared sampling front-end (IMPALA/APPO): sync parallel rounds, or
        draining the background env-runners. May return [] in async mode
        (nothing ready yet) — callers should skip the update for that
        iteration."""
        cfg = self._algo_config
        if async_sampling:
            if not self.workers.is_async:
                self.workers.start_async(cfg.rollout_fragment_length)
            batches = self.workers.sample_async(train_batch_size)
            if not batches:
                # Mass worker failure respawns runners WITHOUT weights; they
                # idle until the next broadcast, which the empty-batch early
                # return would skip — re-broadcast here or the trainer
                # livelocks in async_waiting forever.
                self.sync_worker_weights()
            return batches
        per_worker = max(
            1,
            train_batch_size // max(self.workers.num_workers, 1) // cfg.num_envs_per_worker,
        )
        return self.workers.sample(per_worker)

    def training_step(self) -> dict:
        raise NotImplementedError

    def step(self) -> dict:
        t0 = time.time()
        result = self.training_step()
        # Honor the reporting floor: keep running training_steps until the
        # iteration has consumed min_time_s_per_iteration of wall clock
        # (reference: .reporting() min_time_s_per_iteration).
        min_time = getattr(self._algo_config, "min_time_s_per_iteration", None)
        while min_time and time.time() - t0 < float(min_time):
            result = self.training_step()
        # Keep observation-filter statistics consistent across workers
        # (reference: FilterManager.synchronize each iteration).
        if getattr(self.workers, "observation_filter", None):
            self.workers.sync_filters()
        stats = self.workers.episode_stats()
        window = int(getattr(self._algo_config, "metrics_num_episodes_for_smoothing", 100))
        self._episode_reward_window += stats["episode_rewards"]
        self._episode_reward_window = self._episode_reward_window[-window:]
        result.setdefault("episode_reward_mean", float(np.mean(self._episode_reward_window)) if self._episode_reward_window else float("nan"))
        result["episodes_this_iter"] = len(stats["episode_rewards"])
        result["timesteps_total"] = self._timesteps_total
        result["time_this_iter_s"] = time.time() - t0
        return result

    def save(self) -> Checkpoint:
        """Trainable.save + the checkpoint callback — overriding here (not
        save_checkpoint) covers every algorithm's custom checkpoint
        format."""
        ckpt = super().save()
        self.callbacks.on_checkpoint_saved(algorithm=self, checkpoint=ckpt)
        return ckpt

    def restore(self, checkpoint: Checkpoint) -> None:
        super().restore(checkpoint)
        self.callbacks.on_checkpoint_loaded(algorithm=self)

    def save_checkpoint(self) -> Checkpoint:
        return Checkpoint.from_dict({"weights": self.learner_group.get_weights(), "timesteps": self._timesteps_total})

    def load_checkpoint(self, checkpoint: Checkpoint) -> None:
        data = checkpoint.to_dict()
        self.learner_group.set_weights(data["weights"])
        self._timesteps_total = data.get("timesteps", 0)
        self.workers.sync_weights(data["weights"])

    def cleanup(self) -> None:
        if getattr(self, "_weight_group", None):
            # Release the weight group's name in this process (the samplers
            # and a learner actor leave with their actors below).
            from ray_tpu_torch.util import collective

            collective.destroy_collective_group(self._weight_group)
            self._weight_group = None
        self._device_sync_ready = False
        workers = getattr(self, "workers", None)
        if workers is not None:
            workers.stop()
        eval_ws = getattr(self, "_eval_workers", None)
        if eval_ws is not None:
            eval_ws.stop()
            self._eval_workers = None
        lg = getattr(self, "learner_group", None)
        if lg is not None and hasattr(lg, "stop"):
            lg.stop()

    # -- convenience (reference: Algorithm.compute_single_action) ----------
    def compute_single_action(self, obs, explore: bool = False):
        """One observation's action from the learner's current weights, on
        the config's device (the card unless it asks for the CPU)."""
        import torch

        obs = np.asarray(obs, np.float32)
        # Policies trained behind an observation filter must see filtered
        # observations at inference too.
        base = getattr(self.workers, "_filter_base", None)
        if base is not None:
            from ray_tpu_torch.rllib.connectors import MeanStdFilter

            f = MeanStdFilter()
            f.set_state(base)
            obs = f.transform(obs[None])[0]
        module = self._acting_module()
        x = torch.from_numpy(np.ascontiguousarray(obs, np.float32)[None]).to(module.device)
        with torch.no_grad():
            actions, _, _ = module.sample_actions(x, torch.Generator(device=module.device).manual_seed(0), explore)
        a = actions[0].cpu().numpy()
        return a.item() if self.module_spec.discrete else a

    def _acting_module(self):
        """The in-process learner's module when it lives on the config's
        device; else a module there holding the learner group's weights."""
        from ray_tpu_torch.rllib.core.rl_module import RLModule, _device

        dev = _device(self._algo_config.device)
        local = self.learner_group.local_learner
        if local is not None and local.device == dev:
            return local.module
        if self._act_module is None:
            self._act_module = RLModule(self.module_spec, device=dev).requires_grad_(False)
        return self._act_module.load_params(self.learner_group.get_weights())

    def get_policy_weights(self):
        return self.learner_group.get_weights()

    def get_policy(self):
        """Legacy-API view of the trained module (reference:
        Algorithm.get_policy → rllib/policy/policy.py:175). The returned
        Policy shares NO live state — it snapshots current weights (and the
        observation-filter statistics, which a filtered policy needs at
        inference); call again after more training for fresh ones."""
        from ray_tpu_torch.rllib.policy.policy import Policy

        return Policy(
            self.module_spec,
            self.learner_group.get_weights(),
            config={
                "gamma": getattr(self.config, "gamma", 0.99),
                "lambda": getattr(self.config, "lambda_", 0.95),
            },
            obs_filter_state=getattr(self.workers, "_filter_base", None),
            device=self._algo_config.device,
        )
