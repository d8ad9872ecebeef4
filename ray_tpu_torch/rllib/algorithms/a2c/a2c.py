"""A2C — synchronous advantage actor-critic.

Reference: rllib/algorithms/a2c/a2c.py (A2C = A3C made synchronous: one
gradient step per synchronous sample round, no surrogate clipping). The loss
is one policy-gradient step on GAE advantages, run inside the Learner — the
degenerate case of PPO with one epoch and no ratio clip, which is exactly how
the reference implements it on top of the shared policy-gradient machinery.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    ADVANTAGES,
    OBS,
    VALUE_TARGETS,
    SampleBatch,
)


def a2c_loss(module, batch, spec, cfg):
    """Policy gradient on GAE advantages + value loss - entropy bonus.
    ``module`` is an RLModule, ``batch`` a dict of tensors on its device."""
    import torch

    logp, entropy, value = module.action_logp_and_entropy(batch[OBS], batch[ACTIONS])
    adv = batch[ADVANTAGES]
    policy_loss = -torch.mean(logp * adv)
    vf_loss = 0.5 * torch.mean((value - batch[VALUE_TARGETS]) ** 2)
    entropy_mean = entropy.mean()
    total = policy_loss + cfg["vf_loss_coeff"] * vf_loss - cfg["entropy_coeff"] * entropy_mean
    return total, {
        "policy_loss": policy_loss,
        "vf_loss": vf_loss,
        "entropy": entropy_mean,
    }


class A2CConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or A2C)
        self.lr = 1e-3
        self.train_batch_size = 500
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.grad_clip = 40.0
        self.microbatch_size: Optional[int] = None

    def training(self, *, vf_loss_coeff: Optional[float] = None,
                 entropy_coeff: Optional[float] = None,
                 microbatch_size: Optional[int] = None, **kwargs) -> "A2CConfig":
        super().training(**kwargs)
        if vf_loss_coeff is not None:
            self.vf_loss_coeff = vf_loss_coeff
        if entropy_coeff is not None:
            self.entropy_coeff = entropy_coeff
        if microbatch_size is not None:
            self.microbatch_size = microbatch_size
        return self


class A2C(Algorithm):
    @classmethod
    def get_default_config(cls) -> A2CConfig:
        return A2CConfig(cls)

    def _build_learner_group(self, cfg: A2CConfig) -> LearnerGroup:
        return LearnerGroup(
            self.module_spec,
            a2c_loss,
            lr=cfg.lr,
            grad_clip=cfg.grad_clip,
            seed=cfg.seed,
            num_learners=cfg.num_learners,
            num_gpus_per_learner=cfg.num_gpus_per_learner,
            device=cfg.device,
        )

    def training_step(self) -> dict:
        cfg: A2CConfig = self._algo_config
        per_worker = max(
            1, cfg.train_batch_size // max(self.workers.num_workers, 1) // cfg.num_envs_per_worker
        )
        batches = self.workers.sample(per_worker)
        batch = SampleBatch.concat_samples(batches)
        self._timesteps_total += batch.count
        loss_cfg = {"vf_loss_coeff": cfg.vf_loss_coeff, "entropy_coeff": cfg.entropy_coeff}
        # Default: one gradient step on the whole round (reference: a2c.py
        # training_step). microbatch_size instead takes one optimizer step
        # PER microbatch (sequential SGD over the round) — it bounds learner
        # memory but is not gradient-accumulation-equivalent to the full step.
        if cfg.microbatch_size:
            metrics = {}
            for start in range(0, batch.count, cfg.microbatch_size):
                metrics = self.learner_group.update(
                    batch.slice(start, min(start + cfg.microbatch_size, batch.count)), loss_cfg
                )
        else:
            metrics = self.learner_group.update(batch, loss_cfg)
        self.workers.sync_weights(self.learner_group.get_weights())
        metrics["num_env_steps_sampled_this_iter"] = batch.count
        return dict(metrics)
