"""MAML — model-agnostic meta-learning over task-settable envs.

Reference: rllib/algorithms/maml/maml.py (Finn et al. 2017, RL variant):
each meta-iteration samples a batch of tasks; workers collect pre-adaptation
rollouts with the meta-policy, the policy takes per-task inner policy-
gradient steps, workers collect post-adaptation rollouts with the adapted
policies, and the meta-update differentiates the post-adaptation surrogate
THROUGH the inner gradient steps (maml.py training_step + the
higher-order-grad workers in maml_torch_policy.py).

The meta-policy is an RLModule on the config's device (the card by default),
held by a :class:`MetaLearner` with its Adam. The inner adaptation is a
function of the parameters, ``adapted(theta) = theta - lr * grad(pg_loss)``,
over a functional call of the module (``torch.func.functional_call``); the
inner gradient is taken with ``create_graph=True``, so the meta-gradient
differentiates through it (true second-order MAML). The per-task losses are
averaged over a Python loop on the task axis (the reference vmaps it), and
the update runs in full f32 (``full_f32``). Workers are CPU actors pinned to
the host: they only collect data; gradients never leave the calling process.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32, to_device
from ray_tpu_torch.rllib.core.rl_module import (
    RLModule,
    _device,
    action_logp_and_entropy_at,
    tree_leaves,
    tree_unflatten_like,
)
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    ADVANTAGES,
    DONES,
    LOGPS,
    OBS,
    REWARDS,
    VALUE_TARGETS,
    VF_PREDS,
    SampleBatch,
    compute_gae,
)


def _normalized(adv):
    # The population std (ddof 0), as the reference's jnp std computes it.
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def inner_pg_loss(module, params: dict, batch: dict):
    """Vanilla policy-gradient loss for the inner adaptation step
    (reference: maml uses plain PG inside, surrogate outside), at ``params``
    (parameter name -> tensor)."""
    logp, _, _ = action_logp_and_entropy_at(module, params, batch[OBS], batch[ACTIONS])
    return -torch.mean(logp * _normalized(batch[ADVANTAGES]))


def make_inner_adapt(module, inner_lr: float, inner_steps: int):
    """Returns ``adapt(params, task_batch, create_graph=True)`` — the
    parameters after ``inner_steps`` plain gradient steps, differentiable in
    ``params``. With ``create_graph=True`` the inner gradients stay in the
    graph (the second-order meta-gradient); with ``False`` they are
    constants (first-order, or evaluation)."""

    def adapt(params: dict, batch: dict, create_graph: bool = True) -> dict:
        for _ in range(inner_steps):
            params = {k: p if p.requires_grad else p.detach().requires_grad_(True) for k, p in params.items()}
            # The value head is not in the PG loss: its gradient is zero (as
            # jax.grad gives it), so it leaves the head as it is.
            grads = torch.autograd.grad(inner_pg_loss(module, params, batch), list(params.values()),
                                        create_graph=create_graph, allow_unused=True)
            params = {k: p if g is None else p - inner_lr * g for (k, p), g in zip(params.items(), grads)}
        return params

    return adapt


def outer_surrogate_loss(module, adapted: dict, batch: dict, cfg: dict):
    """PPO-clip surrogate + vf + entropy on the post-adaptation batch,
    evaluated at the adapted parameters (grad flows back into theta)."""
    logp, entropy, value = action_logp_and_entropy_at(module, adapted, batch[OBS], batch[ACTIONS])
    ratio = torch.exp(logp - batch[LOGPS])
    adv = _normalized(batch[ADVANTAGES])
    clip = cfg["clip_param"]
    surrogate = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    vf_loss = torch.mean((value - batch[VALUE_TARGETS]) ** 2)
    return -surrogate.mean() + cfg["vf_loss_coeff"] * vf_loss - cfg["entropy_coeff"] * entropy.mean()


def task_slice(stack: dict, i: int) -> dict:
    """Task ``i``'s batch of a ``[n_tasks, rows, ...]`` stack."""
    return {k: v[i] for k, v in stack.items()}


def stack_batches(batches, device) -> dict:
    """Per-task batches of equal rows as ``[n_tasks, rows, ...]`` tensors on
    ``device``."""
    return to_device({k: np.stack([b[k] for b in batches]) for k in batches[0].keys()}, device)


class MetaLearner:
    """The meta-policy on a device: an RLModule (the reference's params
    tree), one Adam over it in the reference's leaf order, and the meta-update
    differentiating the post-adaptation loss through the inner steps. MAML and
    MBMPO share it."""

    def __init__(self, spec, *, seed: int, lr: float, inner_lr: float, inner_steps: int, loss_cfg: dict,
                 device="cuda"):
        self.device = _device(device)
        self.module = RLModule(spec, seed, device=self.device)
        self.loss_cfg = dict(loss_cfg)
        self._leaves = tree_leaves(self.module.param_tree())
        names = {id(p): n for n, p in self.module.named_parameters()}
        self._names = [names[id(p)] for p in self._leaves]
        self.opt = OptaxChain(self._leaves, lr)
        self.adapt = make_inner_adapt(self.module, inner_lr, inner_steps)

    def params(self) -> dict:
        """The meta-parameters, name -> tensor (the module's own)."""
        return dict(zip(self._names, self._leaves))

    def host_tree(self, params: dict) -> dict:
        """``params`` as a numpy tree in the reference's layout."""
        return tree_unflatten_like(self.module.param_tree(),
                                   [params[n].detach().cpu().numpy().copy() for n in self._names])

    def adapted_params(self, pre_stack: dict) -> list:
        """Each task's adapted parameters (name -> tensor on the device, no
        graph), from the meta-policy and that task's pre-adaptation batch."""
        with full_f32(self.device):
            return [{k: p.detach() for k, p in
                     self.adapt(self.params(), task_slice(pre_stack, i), create_graph=False).items()}
                    for i in range(len(pre_stack[OBS]))]

    def adapted_weights(self, pre_stack: dict) -> list:
        """:meth:`adapted_params` as numpy trees (the weights a worker loads)."""
        return [self.host_tree(p) for p in self.adapted_params(pre_stack)]

    def meta_loss_and_grads(self, pre_stack: dict, post_stack: dict):
        """(the mean over tasks of the post-adaptation loss, its second-order
        gradients in the reference's leaf order)."""
        with full_f32(self.device):
            params = self.params()
            losses = [outer_surrogate_loss(self.module, self.adapt(params, task_slice(pre_stack, i)),
                                           task_slice(post_stack, i), self.loss_cfg)
                      for i in range(len(pre_stack[OBS]))]
            loss = torch.stack(losses).mean()
            grads = torch.autograd.grad(loss, self._leaves)
        return loss.detach(), grads

    def meta_update(self, pre_stack: dict, post_stack: dict):
        """One Adam step on the second-order meta-gradient; returns the loss
        (a tensor on the device)."""
        loss, grads = self.meta_loss_and_grads(pre_stack, post_stack)
        with full_f32(self.device):
            self.opt.step(grads)
        return loss

    @torch.no_grad()
    def act(self, obs, explore: bool = False):
        """One observation's action, with the reference's fixed key: a
        generator seeded 0."""
        x = torch.from_numpy(np.asarray(obs, np.float32).reshape(1, -1)).to(self.device)
        with full_f32(self.device):
            actions, _, _ = self.module.sample_actions(x, torch.Generator(device=self.device).manual_seed(0),
                                                       explore)
        return actions[0].cpu().numpy()


class _MAMLWorker:
    """Task rollout actor: fixed-horizon episodes on a task-settable env.

    Uniform shapes (episodes never terminate early on the meta envs) let
    the caller stack per-task batches into one [n_tasks, rows, ...] array
    for the meta-update. The sampling forward runs here on the CPU (the actor
    holds no card), drawing from a generator seeded as the reference seeds
    its key (``seed * 7919 + worker_index``)."""

    def __init__(self, env, env_config, spec, worker_index, gamma, lambda_, seed):
        from ray_tpu_torch.rllib.env.cartpole import make
        from ray_tpu_torch.rllib.evaluation.rollout_worker import _in_actor_process

        if _in_actor_process():
            from ray_tpu_torch._private.serialization import pin_to_host

            pin_to_host()
            torch.set_num_threads(1)
        self.env = make(env) if isinstance(env, str) else env(dict(env_config))
        self.spec = spec
        self.gamma = gamma
        self.lambda_ = lambda_
        self._module = RLModule(spec, device="cpu").requires_grad_(False)
        self._gen = torch.Generator().manual_seed(seed * 7919 + worker_index)

    def set_task(self, task):
        self.env.set_task(task)
        return True

    def sample(self, weights, n_episodes: int):
        """n_episodes fixed-horizon episodes; GAE per episode; returns the
        stacked columns + the mean episode reward."""
        self._module.load_params(weights)
        frags = []
        ep_rewards = []
        for _ in range(n_episodes):
            obs, _ = self.env.reset()
            cols = {k: [] for k in (OBS, ACTIONS, REWARDS, DONES, LOGPS, VF_PREDS)}
            total = 0.0
            while True:
                o = np.asarray(obs, np.float32)
                with torch.no_grad():
                    a, logp, v = self._module.sample_actions(torch.from_numpy(o)[None], self._gen, True)
                a_np = a.numpy()[0]
                env_a = np.clip(a_np, self.env.action_space.low, self.env.action_space.high)
                obs, r, terminated, truncated, _ = self.env.step(env_a)
                total += float(r)
                cols[OBS].append(o)
                cols[ACTIONS].append(a_np)
                cols[REWARDS].append(np.float32(r))
                cols[DONES].append(np.float32(terminated))
                cols[LOGPS].append(logp.numpy()[0])
                cols[VF_PREDS].append(v.numpy()[0])
                if terminated or truncated:
                    break
            frag = SampleBatch({k: np.stack(v) for k, v in cols.items()})
            frag = compute_gae(frag, 0.0, self.gamma, self.lambda_)
            frags.append(frag)
            ep_rewards.append(total)
        batch = SampleBatch.concat_samples(frags)
        return {k: np.asarray(v) for k, v in batch.items()}, float(np.mean(ep_rewards))

    def stop(self):
        try:
            self.env.close()
        except Exception:
            pass
        return True


class MAMLConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MAML)
        self.lr = 1e-3               # outer (meta) learning rate
        self.inner_lr = 0.1          # inner adaptation step size
        self.inner_adaptation_steps = 1
        self.maml_optimizer_steps = 5
        self.meta_batch_size = 10    # tasks per meta-iteration
        self.episodes_per_task = 10
        self.clip_param = 0.2
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.num_rollout_workers = 2

    def training(self, *, inner_lr: Optional[float] = None,
                 inner_adaptation_steps: Optional[int] = None,
                 maml_optimizer_steps: Optional[int] = None,
                 meta_batch_size: Optional[int] = None,
                 episodes_per_task: Optional[int] = None,
                 clip_param: Optional[float] = None,
                 vf_loss_coeff: Optional[float] = None,
                 entropy_coeff: Optional[float] = None, **kwargs) -> "MAMLConfig":
        super().training(**kwargs)
        for name, val in (
            ("inner_lr", inner_lr),
            ("inner_adaptation_steps", inner_adaptation_steps),
            ("maml_optimizer_steps", maml_optimizer_steps),
            ("meta_batch_size", meta_batch_size),
            ("episodes_per_task", episodes_per_task),
            ("clip_param", clip_param),
            ("vf_loss_coeff", vf_loss_coeff),
            ("entropy_coeff", entropy_coeff),
        ):
            if val is not None:
                setattr(self, name, val)
        return self

    def meta_learner(self, spec, device) -> MetaLearner:
        """The config's meta-policy learner for the module ``spec``."""
        return MetaLearner(spec, seed=self.seed, lr=self.lr, inner_lr=self.inner_lr,
                           inner_steps=self.inner_adaptation_steps,
                           loss_cfg={"clip_param": self.clip_param, "vf_loss_coeff": self.vf_loss_coeff,
                                     "entropy_coeff": self.entropy_coeff},
                           device=device)


class MAML(Algorithm):
    @classmethod
    def get_default_config(cls) -> MAMLConfig:
        return MAMLConfig(cls)

    def setup(self, config: dict) -> None:
        self.cleanup()
        cfg: MAMLConfig = self._algo_config
        self.device = _device(cfg.device)  # no card and no device="cpu": raise before the env and workers
        from ray_tpu_torch.rllib.env.cartpole import make
        from ray_tpu_torch.rllib.models import ModelCatalog

        self._task_env = make(cfg.env) if isinstance(cfg.env, str) else cfg.env(dict(cfg.env_config))
        assert hasattr(self._task_env, "sample_tasks"), (
            "MAML needs a task-settable env (sample_tasks/set_task)"
        )
        self.module_spec = ModelCatalog.get_model_spec(
            self._task_env.observation_space, self._task_env.action_space, cfg.model_config()
        )
        self.learner = cfg.meta_learner(self.module_spec, self.device)
        n = max(cfg.num_rollout_workers, 1)
        worker_cls = ray_tpu_torch.remote(num_cpus=1)(_MAMLWorker)
        self.workers = [
            worker_cls.remote(
                cfg.env, dict(cfg.env_config), self.module_spec, i,
                cfg.gamma, cfg.lambda_, cfg.seed,
            )
            for i in range(n)
        ]
        self._timesteps_total = 0
        self._episode_reward_window: list = []

    def get_policy_weights(self):
        return self.learner.module.get_params()

    def _collect(self, weights_per_task, tasks):
        """Round-robin the (task, weights) pairs over the worker pool."""
        cfg: MAMLConfig = self._algo_config
        refs = []
        for i, task in enumerate(tasks):
            w = self.workers[i % len(self.workers)]
            # Serialize per-task on the worker: set_task then sample are
            # actor calls, ordered per submitter.
            w.set_task.remote(task)
            refs.append(w.sample.remote(weights_per_task[i], cfg.episodes_per_task))
        out = ray_tpu_torch.get(refs, timeout=600)
        batches = [SampleBatch(cols) for cols, _ in out]
        rewards = [r for _, r in out]
        return batches, rewards

    def training_step(self) -> dict:
        cfg: MAMLConfig = self._algo_config
        tasks = self._task_env.sample_tasks(cfg.meta_batch_size)
        theta_np = self.get_policy_weights()

        # 1. Pre-adaptation rollouts with the meta-policy on every task.
        pre_batches, pre_rewards = self._collect([theta_np] * len(tasks), tasks)

        # 2. Per-task inner adaptation (the function the meta-update
        # differentiates through — evaluated here, differentiated there).
        pre_stack = stack_batches(pre_batches, self.device)
        adapted_np = self.learner.adapted_weights(pre_stack)

        # 3. Post-adaptation rollouts with each task's adapted policy.
        post_batches, post_rewards = self._collect(adapted_np, tasks)
        post_stack = stack_batches(post_batches, self.device)

        # 4. Meta-update: differentiate the post-adaptation surrogate
        # through the inner steps (second-order).
        loss = None
        for _ in range(cfg.maml_optimizer_steps):
            loss = self.learner.meta_update(pre_stack, post_stack)
        n_rows = sum(b.count for b in pre_batches) + sum(b.count for b in post_batches)
        self._timesteps_total += n_rows
        self._episode_reward_window += post_rewards
        self._episode_reward_window = self._episode_reward_window[-100:]
        pre, post = float(np.mean(pre_rewards)), float(np.mean(post_rewards))
        return {
            "meta_loss": float(loss),
            "pre_adaptation_reward_mean": pre,
            "post_adaptation_reward_mean": post,
            # The MAML headline number: what one inner step buys.
            "adaptation_delta": post - pre,
            "num_env_steps_sampled_this_iter": n_rows,
        }

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

    def adapt_to_task(self, task, n_episodes: Optional[int] = None):
        """Deploy-time adaptation: collect rollouts on `task` with the
        meta-policy and return task-adapted weights (the reference exposes
        this implicitly via its inner loop; here it is a public API)."""
        cfg: MAMLConfig = self._algo_config
        w = self.workers[0]
        ray_tpu_torch.get(w.set_task.remote(task), timeout=60)
        cols, _ = ray_tpu_torch.get(
            w.sample.remote(self.get_policy_weights(), n_episodes or cfg.episodes_per_task),
            timeout=300,
        )
        return self.learner.adapted_weights(stack_batches([cols], self.device))[0]

    def compute_single_action(self, obs, explore: bool = False):
        a = self.learner.act(obs, explore)
        return a.item() if self.module_spec.discrete else a

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict(
            {"weights": self.get_policy_weights(), "timesteps": self._timesteps_total}
        )

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        self.learner.module.load_params(data["weights"])
        self._timesteps_total = data.get("timesteps", 0)

    def cleanup(self) -> None:
        for w in getattr(self, "workers", []):
            try:
                ray_tpu_torch.get(w.stop.remote(), timeout=10)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        env = getattr(self, "_task_env", None)
        if env is not None:
            try:
                env.close()
            except Exception:
                pass
            self._task_env = None
        eval_ws = getattr(self, "_eval_workers", None)
        if eval_ws is not None:
            eval_ws.stop()
            self._eval_workers = None
