"""IMPALA — importance-weighted actor-learner with V-trace.

Reference: rllib/algorithms/impala/ (+ vtrace_tf/torch). Architecturally the
shape differs from the reference's async queues: rollout workers sample
with whatever weights they last received (behavior policy), the learner
corrects the off-policyness with V-trace importance weights inside one
loss, and weight broadcast happens once per iteration — decoupled
actors/learner without a Python-side queue: one big batch, one update.

V-trace (Espeholt et al. 2018):
    rho_t = min(rho_bar, pi(a|s)/mu(a|s));  c_t = min(c_bar, rho_t)
    delta_t = rho_t (r_t + gamma V(s_{t+1}) - V(s_t))
    vs_t = V(s_t) + delta_t + gamma c_t (vs_{t+1} - V(s_{t+1}))
    pg_adv_t = rho_t (r_t + gamma vs_{t+1} - V(s_t))
computed with a log-depth scan (utils/vtrace.py); episode ends reset the
recursion via the dones mask. Bootstrap values ride in the batch (NEXT_VF_PREDS).
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


def impala_loss(module, batch, spec, cfg):
    import torch

    from ray_tpu_torch.rllib.utils.vtrace import vtrace

    logp, entropy, values = module.action_logp_and_entropy(batch[OBS], batch[ACTIONS])
    nonterminal = 1.0 - batch[DONES].to(values.dtype)
    # Fragment cuts: the batch is a concatenation of per-env rollout
    # fragments; the recursion must reset at each fragment's last row (the
    # bootstrap value there already carries the tail's contribution).
    cuts = batch[FRAG_CUT].to(values.dtype)
    vs, pg_adv, rho = vtrace(
        values.detach(), batch[NEXT_VF_PREDS], logp, batch[LOGPS],
        batch[REWARDS], nonterminal, cuts, cfg["gamma"], cfg["rho_bar"], cfg["c_bar"],
    )
    policy_loss = -torch.mean(logp * pg_adv)
    vf_loss = 0.5 * torch.mean((vs - values) ** 2)
    entropy_mean = entropy.mean()
    total = policy_loss + cfg["vf_loss_coeff"] * vf_loss - cfg["entropy_coeff"] * entropy_mean
    return total, {
        "policy_loss": policy_loss,
        "vf_loss": vf_loss,
        "entropy": entropy_mean,
        "mean_rho": rho.mean(),
    }


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or IMPALA)
        self.lr = 5e-4
        self.train_batch_size = 2000
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.grad_clip = 40.0
        self.rho_bar = 1.0
        self.c_bar = 1.0
        self.minibatch_size = 512
        self.num_sgd_iter = 1
        # Broadcast weights every N iterations (staleness is what V-trace
        # corrects; >1 models the reference's async actors).
        self.broadcast_interval = 1
        # True async actors (reference: AsyncSampler/EnvRunnerV2): workers
        # keep stepping in a background thread while the learner updates;
        # the learner drains whatever fragments are ready. V-trace absorbs
        # the extra staleness this introduces.
        self.async_sampling = False

    def training(self, *, vf_loss_coeff: Optional[float] = None,
                 entropy_coeff: Optional[float] = None, rho_bar: Optional[float] = None,
                 c_bar: Optional[float] = None, minibatch_size: Optional[int] = None,
                 num_sgd_iter: Optional[int] = None, broadcast_interval: Optional[int] = None,
                 async_sampling: Optional[bool] = None,
                 **kwargs) -> "IMPALAConfig":
        super().training(**kwargs)
        for name, value in (
            ("vf_loss_coeff", vf_loss_coeff),
            ("entropy_coeff", entropy_coeff),
            ("rho_bar", rho_bar),
            ("c_bar", c_bar),
            ("minibatch_size", minibatch_size),
            ("num_sgd_iter", num_sgd_iter),
            ("broadcast_interval", broadcast_interval),
            ("async_sampling", async_sampling),
        ):
            if value is not None:
                setattr(self, name, value)
        return self


class IMPALA(Algorithm):
    @classmethod
    def get_default_config(cls) -> IMPALAConfig:
        return IMPALAConfig(cls)

    def _build_learner_group(self, cfg: IMPALAConfig) -> LearnerGroup:
        return LearnerGroup(
            self.module_spec,
            impala_loss,
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
        cfg: IMPALAConfig = self._algo_config
        batches = self._gather_rollouts(cfg.train_batch_size, cfg.async_sampling)
        if not batches:
            return {"async_waiting": 1.0}
        batch = SampleBatch.concat_samples(batches)
        self._timesteps_total += batch.count
        loss_cfg = {
            "gamma": cfg.gamma,
            "rho_bar": cfg.rho_bar,
            "c_bar": cfg.c_bar,
            "vf_loss_coeff": cfg.vf_loss_coeff,
            "entropy_coeff": cfg.entropy_coeff,
        }
        # V-trace needs contiguous time order — update on the WHOLE batch
        # (no shuffled minibatches like PPO).
        metrics = {}
        for _ in range(cfg.num_sgd_iter):
            metrics = self.learner_group.update(batch, loss_cfg)
        if self.iteration % max(cfg.broadcast_interval, 1) == 0:
            # Podracer seam: one device-object group broadcast when the
            # config picked weight_sync="device_broadcast", per-worker host
            # pytree sync otherwise.
            self.sync_worker_weights()
        return dict(metrics)
