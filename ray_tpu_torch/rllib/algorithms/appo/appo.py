"""APPO — asynchronous PPO (IMPALA architecture + clipped surrogate).

Reference: rllib/algorithms/appo/appo.py (+ appo_torch_policy loss): the
IMPALA actor-learner decoupling (behavior-policy rollouts, V-trace targets)
with PPO's clipped-surrogate objective computed against the V-trace policy-
gradient advantages, plus a target network whose KL anchors the update
(use_kl_loss). The shape matches our IMPALA: decoupled staleness is modeled
by broadcast_interval, the correction lives inside one loss.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    DONES,
    FRAG_CUT,
    LOGPS,
    NEXT_VF_PREDS,
    OBS,
    REWARDS,
    SampleBatch,
)


def appo_loss(module, batch, spec, cfg):
    import torch

    from ray_tpu_torch.rllib.utils.vtrace import vtrace

    logp, entropy, values = module.action_logp_and_entropy(batch[OBS], batch[ACTIONS])
    nonterminal = 1.0 - batch[DONES].to(values.dtype)
    cuts = batch[FRAG_CUT].to(values.dtype)
    vs, pg_adv, _ = vtrace(
        values.detach(), batch[NEXT_VF_PREDS], logp, batch[LOGPS],
        batch[REWARDS], nonterminal, cuts, cfg["gamma"], cfg["rho_bar"], cfg["c_bar"],
    )
    # PPO surrogate on the V-trace advantages (reference: appo loss).
    ratio = torch.exp(logp - batch[LOGPS])
    clip = cfg["clip_param"]
    surrogate = torch.minimum(ratio * pg_adv, torch.clamp(ratio, 1 - clip, 1 + clip) * pg_adv)
    policy_loss = -surrogate.mean()
    vf_loss = 0.5 * torch.mean((vs - values) ** 2)
    entropy_mean = entropy.mean()
    # KL(behavior || current) as a soft anchor (reference: use_kl_loss).
    kl = (batch[LOGPS] - logp).mean()
    total = (
        policy_loss
        + cfg["vf_loss_coeff"] * vf_loss
        - cfg["entropy_coeff"] * entropy_mean
        + cfg["kl_coeff"] * torch.clamp(kl, min=0.0)
    )
    return total, {
        "policy_loss": policy_loss,
        "vf_loss": vf_loss,
        "entropy": entropy_mean,
        "kl": kl,
    }


class APPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or APPO)
        self.lr = 5e-4
        self.train_batch_size = 2000
        self.clip_param = 0.2
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.kl_coeff = 0.2
        self.grad_clip = 40.0
        self.rho_bar = 1.0
        self.c_bar = 1.0
        self.num_sgd_iter = 2
        self.broadcast_interval = 1
        # Background-thread actors (see IMPALAConfig.async_sampling): the
        # v-trace + PPO-clip loss absorbs the added staleness.
        self.async_sampling = False

    def training(self, *, clip_param: Optional[float] = None, vf_loss_coeff: Optional[float] = None,
                 entropy_coeff: Optional[float] = None, kl_coeff: Optional[float] = None,
                 rho_bar: Optional[float] = None, c_bar: Optional[float] = None,
                 num_sgd_iter: Optional[int] = None, broadcast_interval: Optional[int] = None,
                 async_sampling: Optional[bool] = None,
                 **kwargs) -> "APPOConfig":
        super().training(**kwargs)
        for name, value in (
            ("clip_param", clip_param), ("vf_loss_coeff", vf_loss_coeff),
            ("entropy_coeff", entropy_coeff), ("kl_coeff", kl_coeff),
            ("rho_bar", rho_bar), ("c_bar", c_bar),
            ("num_sgd_iter", num_sgd_iter), ("broadcast_interval", broadcast_interval),
            ("async_sampling", async_sampling),
        ):
            if value is not None:
                setattr(self, name, value)
        return self


class APPO(Algorithm):
    @classmethod
    def get_default_config(cls) -> APPOConfig:
        return APPOConfig(cls)

    def _build_learner_group(self, cfg: APPOConfig) -> LearnerGroup:
        return LearnerGroup(
            self.module_spec,
            appo_loss,
            lr=cfg.lr,
            grad_clip=cfg.grad_clip,
            seed=cfg.seed,
            num_learners=cfg.num_learners,
            num_gpus_per_learner=cfg.num_gpus_per_learner,
            device=cfg.device,
            use_mesh=getattr(cfg, "learner_mesh", False),
            grad_sync=getattr(cfg, "grad_sync", "host"),
        )

    def training_step(self) -> dict:
        cfg: APPOConfig = self._algo_config
        batches = self._gather_rollouts(cfg.train_batch_size, cfg.async_sampling)
        if not batches:
            return {"async_waiting": 1.0}
        batch = SampleBatch.concat_samples(batches)
        self._timesteps_total += batch.count
        loss_cfg = {
            "gamma": cfg.gamma,
            "rho_bar": cfg.rho_bar,
            "c_bar": cfg.c_bar,
            "clip_param": cfg.clip_param,
            "vf_loss_coeff": cfg.vf_loss_coeff,
            "entropy_coeff": cfg.entropy_coeff,
            "kl_coeff": cfg.kl_coeff,
        }
        # V-trace needs contiguous time order — whole-batch epochs, no
        # shuffled minibatches (same constraint as IMPALA).
        metrics = {}
        for _ in range(cfg.num_sgd_iter):
            metrics = self.learner_group.update(batch, loss_cfg)
        if self.iteration % max(cfg.broadcast_interval, 1) == 0:
            # Podracer seam: device-object group broadcast when configured.
            self.sync_worker_weights()
        metrics["num_env_steps_sampled_this_iter"] = batch.count
        return dict(metrics)
