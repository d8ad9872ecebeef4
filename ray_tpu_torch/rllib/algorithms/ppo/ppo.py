"""PPO — proximal policy optimization.

Reference: rllib/algorithms/ppo/ppo.py:394 (PPO, training_step :420) and
ppo_learner/ppo_torch_learner loss. The loss here is a function of the
module and a batch of tensors, run inside the Learner: clipped surrogate +
value loss + entropy bonus,
minibatch SGD over each synchronous sample round, then weight broadcast to
the rollout workers through the object store (§3.6).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    ADVANTAGES,
    LOGPS,
    OBS,
    VALUE_TARGETS,
    VF_PREDS,
    SampleBatch,
)


def ppo_loss(module, batch, spec, cfg):
    """Clipped-surrogate PPO loss (reference: ppo_torch_learner.py loss).
    ``module`` is the learner's RLModule, ``batch`` a dict of tensors on its
    device."""
    import torch

    logp, entropy, value = module.action_logp_and_entropy(batch[OBS], batch[ACTIONS])
    ratio = torch.exp(logp - batch[LOGPS])
    adv = batch[ADVANTAGES]
    # The population std (ddof 0), as the reference computes it; torch's
    # default is the unbiased one.
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    clip = cfg["clip_param"]
    surrogate = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    # Clipped value loss (reference vf_clip_param).
    vf_err = (value - batch[VALUE_TARGETS]) ** 2
    vf_clipped = batch[VF_PREDS] + torch.clamp(value - batch[VF_PREDS], -cfg["vf_clip_param"], cfg["vf_clip_param"])
    vf_err2 = (vf_clipped - batch[VALUE_TARGETS]) ** 2
    vf_loss = torch.maximum(vf_err, vf_err2)
    policy_loss = -surrogate.mean()
    value_loss = vf_loss.mean()
    entropy_mean = entropy.mean()
    total = policy_loss + cfg["vf_loss_coeff"] * value_loss - cfg["entropy_coeff"] * entropy_mean
    kl = (batch[LOGPS] - logp).mean()
    return total, {
        "policy_loss": policy_loss,
        "vf_loss": value_loss,
        "entropy": entropy_mean,
        "kl": kl,
    }


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PPO)
        self.lr = 3e-4
        self.train_batch_size = 2000
        self.sgd_minibatch_size = 128
        self.num_sgd_iter = 8
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.grad_clip = 0.5

    def training(self, *, sgd_minibatch_size: Optional[int] = None, num_sgd_iter: Optional[int] = None,
                 clip_param: Optional[float] = None, vf_clip_param: Optional[float] = None,
                 vf_loss_coeff: Optional[float] = None, entropy_coeff: Optional[float] = None, **kwargs) -> "PPOConfig":
        super().training(**kwargs)
        if sgd_minibatch_size is not None:
            self.sgd_minibatch_size = sgd_minibatch_size
        if num_sgd_iter is not None:
            self.num_sgd_iter = num_sgd_iter
        if clip_param is not None:
            self.clip_param = clip_param
        if vf_clip_param is not None:
            self.vf_clip_param = vf_clip_param
        if vf_loss_coeff is not None:
            self.vf_loss_coeff = vf_loss_coeff
        if entropy_coeff is not None:
            self.entropy_coeff = entropy_coeff
        return self


class PPO(Algorithm):
    @classmethod
    def get_default_config(cls) -> PPOConfig:
        return PPOConfig(cls)

    def _build_learner_group(self, cfg: PPOConfig) -> LearnerGroup:
        return LearnerGroup(
            self.module_spec,
            ppo_loss,
            lr=cfg.lr,
            grad_clip=cfg.grad_clip,
            seed=cfg.seed,
            num_learners=cfg.num_learners,
            num_gpus_per_learner=cfg.num_gpus_per_learner,
            device=cfg.device,
        )

    def training_step(self) -> dict:
        cfg: PPOConfig = self._algo_config
        # 1. Synchronous parallel sampling (reference: rollout_ops.py:21).
        per_worker = max(1, cfg.train_batch_size // max(self.workers.num_workers, 1) // cfg.num_envs_per_worker)
        batches = self.workers.sample(per_worker)
        batch = SampleBatch.concat_samples(batches)
        self._timesteps_total += batch.count
        # 2. Minibatch SGD epochs on the learner group.
        loss_cfg = {
            "clip_param": cfg.clip_param,
            "vf_clip_param": cfg.vf_clip_param,
            "vf_loss_coeff": cfg.vf_loss_coeff,
            "entropy_coeff": cfg.entropy_coeff,
        }
        metrics: dict = {}
        seed = np.random.randint(1 << 31)
        for epoch in range(cfg.num_sgd_iter):
            for mb in batch.minibatches(min(cfg.sgd_minibatch_size, batch.count), seed=seed + epoch):
                metrics = self.learner_group.update(mb, loss_cfg)
        # 3. Broadcast fresh weights to rollout workers.
        self.workers.sync_weights(self.learner_group.get_weights())
        metrics["num_env_steps_sampled_this_iter"] = batch.count
        return metrics
