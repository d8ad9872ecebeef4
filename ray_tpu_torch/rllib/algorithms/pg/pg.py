"""PG — vanilla policy gradient (REINFORCE).

Reference: rllib/algorithms/pg/{pg.py,pg_torch_policy.py}: the simplest
on-policy algorithm — no critic, no clipping; the gradient weight is the
Monte-Carlo return-to-go, batch-normalized as a variance-reduction baseline
(the reference's advantages with use_critic=False reduce to the same thing).
Kept as its own algorithm (not an A2C flag) mirroring the reference's
separate pg/ family and as the minimal template for new on-policy algos.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.policy.sample_batch import ACTIONS, OBS, VALUE_TARGETS, SampleBatch


def pg_loss(module, batch, spec, cfg):
    """REINFORCE on batch-normalized returns-to-go. ``module`` is the
    learner's RLModule, ``batch`` a dict of tensors on its device."""
    import torch

    logp, entropy, _value = module.action_logp_and_entropy(batch[OBS], batch[ACTIONS])
    ret = batch[VALUE_TARGETS]  # discounted returns-to-go
    # The population std (ddof 0), as the reference computes it.
    ret = (ret - ret.mean()) / (ret.std(correction=0) + 1e-8)
    entropy_mean = entropy.mean()
    total = -torch.mean(logp * ret) - cfg["entropy_coeff"] * entropy_mean
    return total, {"policy_loss": total, "entropy": entropy_mean}


class PGConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PG)
        self.lr = 4e-3
        self.train_batch_size = 2000
        self.entropy_coeff = 0.0
        self.grad_clip = 40.0
        # REINFORCE uses Monte-Carlo returns: lambda_=1 collapses GAE to
        # discounted returns minus the value prediction; with the critic
        # untrained the loss re-centers by the batch mean anyway. lambda_ is
        # the field WorkerSet actually consumes for GAE.
        self.lambda_ = 1.0

    def training(self, *, entropy_coeff: Optional[float] = None, **kwargs) -> "PGConfig":
        super().training(**kwargs)
        if entropy_coeff is not None:
            self.entropy_coeff = entropy_coeff
        return self


class PG(Algorithm):
    @classmethod
    def get_default_config(cls) -> PGConfig:
        return PGConfig(cls)

    def _build_learner_group(self, cfg: PGConfig) -> LearnerGroup:
        return LearnerGroup(
            self.module_spec,
            pg_loss,
            lr=cfg.lr,
            grad_clip=cfg.grad_clip,
            seed=cfg.seed,
            num_learners=cfg.num_learners,
            num_gpus_per_learner=cfg.num_gpus_per_learner,
            device=cfg.device,
        )

    def training_step(self) -> dict:
        cfg: PGConfig = self._algo_config
        per_worker = max(
            1, cfg.train_batch_size // max(self.workers.num_workers, 1) // cfg.num_envs_per_worker
        )
        batches = self.workers.sample(per_worker)
        batch = SampleBatch.concat_samples(batches)
        self._timesteps_total += batch.count
        metrics = self.learner_group.update(batch, {"entropy_coeff": cfg.entropy_coeff})
        self.workers.sync_weights(self.learner_group.get_weights())
        metrics["num_env_steps_sampled_this_iter"] = batch.count
        return dict(metrics)
