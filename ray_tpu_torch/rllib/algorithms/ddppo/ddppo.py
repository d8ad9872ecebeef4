"""DDPPO — decentralized distributed PPO.

Reference: rllib/algorithms/ddppo/ddppo.py (Wijmans et al. 2019): sampling
AND SGD both happen inside the rollout workers; gradients are averaged
worker-to-worker with an allreduce (torch DDP over gloo/nccl in the
reference) and each worker applies them locally, so parameters never
transit the driver — it only coordinates rounds and aggregates metrics
(`ddppo.py:90`: "gradients are computed on the workers ... all-reduce").

Here the workers learn on the CPU, as the JAX package's do, whatever the
config's ``device`` says: ``device`` places the driver's acting module
(``compute_single_action``), so the default asks for a card and raises at
setup without one (ROADMAP C14). The allreduce is the port's collective
plane, every minibatch's gradients as one packed vector (a gloo group by
default, the ``collective_backend`` config). Every worker seeds the same
weights and optimizer state, and identical averaged gradients keep them
bit-identical thereafter — asserted cheaply via a weight-digest check each
round.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPOConfig, ppo_loss
from ray_tpu_torch.rllib.core.learner import Learner, _host_metrics, allreduce_mean, global_norm
from ray_tpu_torch.rllib.core.rl_module import _device, tree_leaves
from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker


class _DDPPOWorker(RolloutWorker):
    """Rollout worker that also runs the PPO SGD locally, allreducing
    gradients with its peers each minibatch."""

    def __init__(self, *args, lr=3e-4, grad_clip=0.5, opt_seed=0, **kwargs):
        super().__init__(*args, **kwargs)
        # Same opt_seed everywhere -> identical initial weights on every
        # worker; identical averaged grads keep them in lockstep. Sampling
        # reads the learner's live module (its forwards run under no_grad).
        self._learner = Learner(self.spec, ppo_loss, lr=lr, grad_clip=grad_clip, seed=opt_seed, device="cpu")
        self._module = self._learner.module
        self._params = self._module.get_params()
        self._world = 1
        self._group = None

    def init_collective(self, world_size: int, rank: int, backend: str, group_name: str):
        from ray_tpu_torch.util import collective

        self._world = world_size
        self._group = group_name
        if world_size > 1:
            collective.init_collective_group(
                world_size=world_size, rank=rank, backend=backend, group_name=group_name
            )
        return True

    def train_round(self, fragment_len: int, minibatch_size: int, num_sgd_iter: int,
                    loss_cfg: dict, seed: int):
        """One DDPPO round: sample locally, SGD locally, allreduce grads.

        Every peer calls allreduce the same number of times per round
        (identical fragment/minibatch geometry), which the collective plane
        requires — minibatches() pads/trims identically on every worker.
        """
        batch = self.sample(fragment_len, explore=True)
        learner = self._learner
        metrics: dict = {}
        for epoch in range(num_sgd_iter):
            for i, mb in enumerate(batch.minibatches(min(minibatch_size, batch.count), seed=seed + epoch)):
                loss, m, grads = learner.compute_grads(mb, loss_cfg)
                if self._world > 1:
                    grads = allreduce_mean(grads, self._group, self._world, tag=f"ddppo{seed}_{epoch}_{i}")
                learner.opt.step(grads, global_norm(grads))
                metrics = _host_metrics(m, loss)
        rewards, _lens = self.env.pop_episode_stats()
        return metrics, batch.count, rewards, self.weights_digest()

    def weights_digest(self) -> float:
        """The sum of every weight's absolute value: equal on workers in
        lockstep."""
        return float(sum(np.abs(x).sum() for x in tree_leaves(self._module.get_params())))

    def get_weights(self):
        return self._module.get_params()


class DDPPOConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DDPPO)
        self.num_rollout_workers = 2
        # Per-worker fragment per round (reference: rollout_fragment_length
        # drives the per-worker batch; there is no global train_batch_size).
        self.rollout_fragment_length = 100
        self.sgd_minibatch_size = 64
        self.num_sgd_iter = 4
        self.collective_backend = "gloo"

    def training(self, *, collective_backend: Optional[str] = None, **kwargs) -> "DDPPOConfig":
        super().training(**kwargs)
        if collective_backend is not None:
            self.collective_backend = collective_backend
        return self


class DDPPO(Algorithm):
    @classmethod
    def get_default_config(cls) -> DDPPOConfig:
        return DDPPOConfig(cls)

    def setup(self, config: dict) -> None:
        self.cleanup()
        cfg: DDPPOConfig = self._algo_config
        # The acting module's device; the workers' SGD stays on the CPU.
        self._act_device = _device(cfg.device)
        self.module_spec = self._spec_from_env(cfg)
        n = max(cfg.num_rollout_workers, 1)
        worker_cls = ray_tpu_torch.remote(num_cpus=1)(_DDPPOWorker)
        self.workers = [
            worker_cls.remote(
                cfg.env, self.module_spec, i, max(cfg.num_envs_per_worker, 1),
                dict(cfg.env_config), cfg.gamma, cfg.lambda_, cfg.seed,
                cfg.observation_filter,
                lr=cfg.lr, grad_clip=cfg.grad_clip, opt_seed=cfg.seed,
            )
            for i in range(n)
        ]
        group = f"ddppo_{id(self)}"
        ray_tpu_torch.get(
            [
                w.init_collective.remote(n, rank, cfg.collective_backend, group)
                for rank, w in enumerate(self.workers)
            ],
            timeout=300,
        )
        self._act_module = None
        self._timesteps_total = 0
        self._round = 0
        self._episode_reward_window: list = []

    def training_step(self) -> dict:
        cfg: DDPPOConfig = self._algo_config
        loss_cfg = {
            "clip_param": cfg.clip_param,
            "vf_clip_param": cfg.vf_clip_param,
            "vf_loss_coeff": cfg.vf_loss_coeff,
            "entropy_coeff": cfg.entropy_coeff,
        }
        self._round += 1
        refs = [
            w.train_round.remote(
                cfg.rollout_fragment_length, cfg.sgd_minibatch_size,
                cfg.num_sgd_iter, loss_cfg, self._round * 10_000,
            )
            for w in self.workers
        ]
        results = ray_tpu_torch.get(refs, timeout=600)
        digests = [r[3] for r in results]
        # Lockstep invariant: decentralized updates must agree bit-for-bit
        # (they started identical and applied identical averaged grads).
        if max(digests) - min(digests) > 1e-4 * max(1.0, abs(digests[0])):
            raise RuntimeError(f"DDPPO workers diverged: digests={digests}")
        metrics: dict = {}
        for m, count, rewards, _ in results:
            metrics = m
            self._timesteps_total += count
            self._episode_reward_window += rewards
        self._episode_reward_window = self._episode_reward_window[-100:]
        metrics["num_env_steps_sampled_this_iter"] = sum(r[1] for r in results)
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

    def get_policy_weights(self):
        return ray_tpu_torch.get(self.workers[0].get_weights.remote(), timeout=60)

    def _acting_module(self):
        """A module on the config's device holding worker 0's weights."""
        from ray_tpu_torch.rllib.core.rl_module import RLModule

        if self._act_module is None:
            self._act_module = RLModule(self.module_spec, device=self._act_device).requires_grad_(False)
        return self._act_module.load_params(self.get_policy_weights())

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict(
            {"weights": self.get_policy_weights(), "timesteps": self._timesteps_total}
        )

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        ray_tpu_torch.get(
            [w.set_weights.remote(data["weights"]) for w in self.workers], timeout=300
        )
        self._timesteps_total = data.get("timesteps", 0)

    def cleanup(self) -> None:
        for w in getattr(self, "workers", []):
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        eval_ws = getattr(self, "_eval_workers", None)
        if eval_ws is not None:
            eval_ws.stop()
            self._eval_workers = None
