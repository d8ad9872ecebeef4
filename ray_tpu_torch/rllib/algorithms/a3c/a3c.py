"""A3C — asynchronous advantage actor-critic.

Reference: rllib/algorithms/a3c/a3c.py (Mnih et al. 2016): each rollout
worker computes policy gradients on its OWN fragment and ships gradients
(not samples) to the driver, which applies them to the central weights as
they arrive — no synchronization barrier across workers — and returns fresh
weights to just that worker (training_step :190: `async_parallel_requests`
over `sample_and_compute_grads`).

Here the gradient is the A2C loss's, computed in torch on the worker's CPU
(rollouts stay off the card, rollout_worker.py); the driver holds the weights
and the optimizer state in a :class:`Learner` on the config's device (the
card by default) and applies each incoming gradient in arrival order. The
asynchrony is real — the driver waits on whichever worker finishes first
(``ray_tpu_torch.wait(num_returns=1)``), so a slow worker never gates the
others, at the cost of gradient staleness exactly like the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.a2c.a2c import a2c_loss
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner, to_device
from ray_tpu_torch.rllib.core.rl_module import tree_leaves, tree_unflatten_like
from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker


class _A3CWorker(RolloutWorker):
    """RolloutWorker that also computes the A2C gradient on its fragment."""

    def __init__(self, *args, loss_cfg=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._loss_cfg = dict(loss_cfg or {})
        self._module.requires_grad_(True)  # sampling forwards run under no_grad

    def compute_grads(self, batch):
        """(the A2C gradient of ``batch`` as a numpy tree in the params'
        layout, its metrics with ``total_loss``)."""
        import torch

        tree = self._module.param_tree()
        loss, metrics = a2c_loss(self._module, to_device(batch, torch.device("cpu")), self.spec, self._loss_cfg)
        grads = torch.autograd.grad(loss, tree_leaves(tree))
        out = {k: float(v.detach()) for k, v in metrics.items()}
        out["total_loss"] = float(loss.detach())
        return tree_unflatten_like(tree, [g.numpy() for g in grads]), out

    def sample_and_grad(self, num_steps: int):
        batch = self.sample(num_steps, explore=True)
        grads, metrics = self.compute_grads(batch)
        rewards, _lens = self.env.pop_episode_stats()
        return grads, metrics, batch.count, rewards


class A3CConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or A3C)
        self.lr = 1e-4
        self.grad_clip = 40.0
        self.rollout_fragment_length = 50
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        # Gradient applications per training_step() call (iteration sizing
        # only — the update stream itself is barrier-free).
        self.grads_per_step = 16

    def training(self, *, vf_loss_coeff: Optional[float] = None,
                 entropy_coeff: Optional[float] = None,
                 grads_per_step: Optional[int] = None, **kwargs) -> "A3CConfig":
        super().training(**kwargs)
        if vf_loss_coeff is not None:
            self.vf_loss_coeff = vf_loss_coeff
        if entropy_coeff is not None:
            self.entropy_coeff = entropy_coeff
        if grads_per_step is not None:
            self.grads_per_step = grads_per_step
        return self


class A3C(Algorithm):
    @classmethod
    def get_default_config(cls) -> A3CConfig:
        return A3CConfig(cls)

    def setup(self, config: dict) -> None:
        self.cleanup()
        cfg: A3CConfig = self._algo_config
        self.module_spec = self._spec_from_env(cfg)
        # The weights and the optimizer (optax's chain: clip, adam) on the
        # config's device; the loss runs on the workers.
        self.learner = Learner(self.module_spec, a2c_loss, lr=cfg.lr, grad_clip=cfg.grad_clip, seed=cfg.seed,
                               device=cfg.device)
        loss_cfg = {"vf_loss_coeff": cfg.vf_loss_coeff, "entropy_coeff": cfg.entropy_coeff}
        n = max(cfg.num_rollout_workers, 1)
        worker_cls = ray_tpu_torch.remote(num_cpus=1)(_A3CWorker)
        self.workers = [
            worker_cls.remote(
                cfg.env, self.module_spec, i, max(cfg.num_envs_per_worker, 1),
                dict(cfg.env_config), cfg.gamma, cfg.lambda_, cfg.seed,
                cfg.observation_filter, loss_cfg=loss_cfg,
            )
            for i in range(n)
        ]
        weights = self.get_policy_weights()
        ray_tpu_torch.get([w.set_weights.remote(weights) for w in self.workers], timeout=300)
        # One in-flight gradient task per worker, resubmitted as each lands.
        self._inflight = {
            w.sample_and_grad.remote(cfg.rollout_fragment_length): w for w in self.workers
        }
        self._timesteps_total = 0
        self._episode_reward_window: list = []

    def get_policy_weights(self):
        return self.learner.get_weights()

    def training_step(self) -> dict:
        cfg: A3CConfig = self._algo_config
        metrics: dict = {}
        for _ in range(cfg.grads_per_step):
            # Apply whichever worker's gradient lands first; only THAT
            # worker gets fresh weights and a new task — no barrier.
            done, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1, timeout=120)
            if not done:
                break
            ref = done[0]
            worker = self._inflight.pop(ref)
            try:
                grads, m, count, rewards = ray_tpu_torch.get(ref, timeout=60)
            except Exception:
                # Worker died mid-fragment: drop its task; respawn-free
                # degradation (remaining workers keep the stream alive).
                self.workers = [w for w in self.workers if w is not worker]
                if not self.workers:
                    raise
                continue
            self.learner.apply_gradients(grads)
            metrics = m
            self._timesteps_total += count
            self._episode_reward_window += rewards
            worker.set_weights.remote(self.get_policy_weights())
            self._inflight[worker.sample_and_grad.remote(cfg.rollout_fragment_length)] = worker
        self._episode_reward_window = self._episode_reward_window[-100:]
        return metrics

    def step(self) -> dict:
        import time

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

    def _acting_module(self):
        return self.learner.module

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict(
            {"weights": self.get_policy_weights(), "timesteps": self._timesteps_total}
        )

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        self.learner.set_weights(data["weights"])
        self._timesteps_total = data.get("timesteps", 0)
        ray_tpu_torch.get(
            [w.set_weights.remote(self.get_policy_weights()) for w in self.workers],
            timeout=300,
        )

    def cleanup(self) -> None:
        for w in getattr(self, "workers", []):
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        self._inflight = {}
        eval_ws = getattr(self, "_eval_workers", None)
        if eval_ws is not None:
            eval_ws.stop()
            self._eval_workers = None
