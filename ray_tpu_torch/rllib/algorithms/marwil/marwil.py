"""MARWIL (advantage-weighted behavior cloning) and BC.

Reference: rllib/algorithms/marwil/marwil.py (+ marwil_torch_policy loss) and
rllib/algorithms/bc/ (BC = MARWIL with beta=0). Offline algorithms: the
training batch comes from a JsonReader/DatasetReader instead of rollout
workers; rollout workers are kept only for evaluation.

Loss (on the learner, the card unless the config asks for the CPU): policy
term -E[exp(beta * A / c) * logp(a|s)] with A = (return-to-go - V(s)) and c
the batch RMS of A; value term regresses V(s) on return-to-go. beta = 0 drops
the value influence on the policy term entirely (pure behavior cloning).

The reference gates both terms with ``jnp.where`` on beta; here ``beta`` is a
tensor and the gates are ``torch.where``, so with beta = 0 the value head
still gets a gradient, of zeros, as ``jax.grad`` gives it: the global-norm
clip and Adam see the same zero leaves.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.policy.sample_batch import ACTIONS, OBS, VALUE_TARGETS


def marwil_loss(module, batch, spec, cfg):
    """(total loss, metrics) of one batch of tensors on the module's device."""
    logp, entropy, value = module.action_logp_and_entropy(batch[OBS], batch[ACTIONS])
    beta = torch.full((), cfg["beta"], dtype=value.dtype, device=value.device)  # a fill: no host copy
    targets = batch[VALUE_TARGETS]
    adv = targets - value
    # exp-weighted imitation; advantage normalized by its batch RMS
    # (reference uses a moving average — batch RMS is the jit-friendly form).
    c = torch.sqrt(torch.mean(adv**2) + 1e-8)
    weights = torch.where(beta > 0, torch.exp(beta * (adv / c).detach()), torch.ones_like(adv))
    policy_loss = -torch.mean(weights * logp)
    vf_loss = torch.mean(adv**2)
    total = (
        policy_loss
        + cfg["vf_coeff"] * torch.where(beta > 0, vf_loss, torch.zeros_like(vf_loss))
        - cfg["entropy_coeff"] * entropy.mean()
    )
    return total, {
        "policy_loss": policy_loss,
        "vf_loss": vf_loss,
        "bc_logp": logp.mean(),
        "entropy": entropy.mean(),
    }


class MARWILConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MARWIL)
        self.beta = 1.0
        self.vf_coeff = 1.0
        self.entropy_coeff = 0.0
        self.grad_clip = 40.0
        self.lr = 1e-4
        self.train_batch_size = 2000
        self.input_ = None  # path / glob / list of files / Dataset
        # Offline: no training rollouts; online interaction happens only
        # when the user opts into evaluation via .evaluation(...) — the
        # base Algorithm then runs greedy episodes on a dedicated eval
        # WorkerSet (reference: offline algos default to no online eval).
        self.num_rollout_workers = 0
        self.evaluation_interval = None

    def offline_data(self, *, input_=None, input_reader_kwargs=None) -> "MARWILConfig":
        if input_ is not None:
            self.input_ = input_
        if input_reader_kwargs is not None:
            self.input_reader_kwargs = dict(input_reader_kwargs)
        return self

    def training(self, *, beta: Optional[float] = None, vf_coeff: Optional[float] = None,
                 entropy_coeff: Optional[float] = None, **kwargs) -> "MARWILConfig":
        super().training(**kwargs)
        if beta is not None:
            self.beta = beta
        if vf_coeff is not None:
            self.vf_coeff = vf_coeff
        if entropy_coeff is not None:
            self.entropy_coeff = entropy_coeff
        return self


class MARWIL(Algorithm):
    @classmethod
    def get_default_config(cls) -> MARWILConfig:
        return MARWILConfig(cls)

    def setup(self, config: dict) -> None:
        super().setup(config)  # raises first without a card unless the config asks for the CPU
        cfg: MARWILConfig = self._algo_config
        if cfg.input_ is None:
            raise ValueError(f"{type(self).__name__} requires config.offline_data(input_=...)")
        from ray_tpu_torch.rllib.offline import make_input_reader

        self.reader = make_input_reader(
            cfg.input_, gamma=cfg.gamma, seed=cfg.seed,
            **cfg.input_reader_kwargs,
        )

    def _build_learner_group(self, cfg: MARWILConfig) -> LearnerGroup:
        return LearnerGroup(
            self.module_spec,
            marwil_loss,
            lr=cfg.lr,
            grad_clip=cfg.grad_clip,
            seed=cfg.seed,
            num_learners=cfg.num_learners,
            num_gpus_per_learner=cfg.num_gpus_per_learner,
            device=cfg.device,
        )

    def loss_cfg(self) -> dict:
        cfg: MARWILConfig = self._algo_config
        return {"beta": cfg.beta, "vf_coeff": cfg.vf_coeff, "entropy_coeff": cfg.entropy_coeff}

    def training_step(self) -> dict:
        cfg: MARWILConfig = self._algo_config
        batch = self.reader.next(cfg.train_batch_size)
        self._timesteps_total += len(batch)
        metrics = self.learner_group.update(batch, self.loss_cfg())
        # Evaluation rollouts (the only online interaction) ride the base
        # Algorithm.evaluate() machinery: train() runs greedy episodes on a
        # dedicated eval WorkerSet every evaluation_interval iterations.
        return dict(metrics)


class BCConfig(MARWILConfig):
    """BC = MARWIL with beta=0 (reference: rllib/algorithms/bc/bc.py)."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or BC)
        self.beta = 0.0
        self.vf_coeff = 0.0


class BC(MARWIL):
    @classmethod
    def get_default_config(cls) -> BCConfig:
        return BCConfig(cls)
