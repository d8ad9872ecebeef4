"""CRR — Critic Regularized Regression (offline RL; Wang et al. 2020).

Reference: rllib/algorithms/crr/ (crr.py, torch policy): purely offline
actor-critic where the actor is trained by ADVANTAGE-FILTERED behavior
cloning on dataset actions:

    L_actor = -f(A(s, a)) * log pi(a | s),   A(s,a) = Q(s,a) - E_{a'~pi} Q(s,a')

with f either ``exp`` (exp(A / beta), clipped — CRR-exp) or ``binary``
(1[A > 0] — CRR-binary/"max"). The critic is plain TD against a Polyak
target with the expectation over the CURRENT policy for the bootstrap (no
max — avoids offline overestimation). Unlike CQL there is no explicit
OOD-action penalty: staying near the data comes from the regression form
itself.

One update trains critic + actor with one Adam over ``{"actor", "q"}`` on the
config's device (the card by default); data flows from the offline readers
(rllib/offline), never an env. Discrete spaces take exact expectations over
actions; continuous ones sample from a squashed Gaussian (SAC's machinery).
The reference draws each sample ``i`` of the expectation from
``fold_in(fold_in(key, 1 or 2), i)``; the port takes them as explicit tensors
``draws["next"]`` and ``draws["cur"]`` ([n, B, d] standard normals, sample
``i`` at index ``i``) from a ``torch.Generator`` seeded with ``seed + 1``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.off_policy import (
    OffPolicyTraining,
    env_spaces,
    floats,
    frozen,
    mlp_apply,
    mlp_params,
    mlp_params_from_jax,
    polyak,
    trainable,
)
from ray_tpu_torch.rllib.algorithms.sac.sac import LOG_2PI, _squashed_sample
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32, to_device
from ray_tpu_torch.rllib.core.rl_module import _device, tree_leaves, tree_map
from ray_tpu_torch.rllib.offline import make_input_reader
from ray_tpu_torch.rllib.policy.sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS


def crr_params_from_jax(params: dict, *, device="cuda"):
    """The reference's CRR params (``actor``, ``q``) as the port's tree on
    ``device``; its ``target_q`` (one MLP, a list) as the port's list."""
    if isinstance(params, dict):
        return {k: mlp_params_from_jax(v, device=device) for k, v in params.items()}
    return mlp_params_from_jax(params, device=device)


def _policy_logp_and_expq(actor, q_params, obs, eps, discrete):
    """(the policy head, E_{a~pi} Q(s, a)). ``eps``: [n, B, d] standard
    normals, one [B, d] slice a sample (continuous)."""
    if discrete:
        logits = mlp_apply(actor, obs)
        pi = F.softmax(logits, dim=-1)
        q_all = mlp_apply(q_params, obs)          # [B, A]
        return logits, torch.sum(pi * q_all, dim=-1)
    # Continuous: sample n actions from the squashed Gaussian.
    out = mlp_apply(actor, obs)
    action_dim = out.shape[-1] // 2
    mean, log_std = out[:, :action_dim], out[:, action_dim:]
    log_std = torch.clamp(log_std, -10.0, 2.0)
    qs = []
    for i in range(eps.shape[0]):
        a, _, _ = _squashed_sample(actor, obs, eps[i], action_dim)
        qs.append(mlp_apply(q_params, torch.cat([obs, a], -1))[..., 0])
    return (mean, log_std), torch.mean(torch.stack(qs), dim=0)


def crr_loss(params, target_q, batch, draws, *, discrete, gamma, beta, wmax, binary):
    """(total loss, metrics) of one CRR batch of tensors."""
    obs, acts, rew, dones, next_obs = batch[OBS], batch[ACTIONS], batch[REWARDS], batch[DONES], batch[NEXT_OBS]
    # ---- critic: TD with E_pi[Q_target] bootstrap (no max) ----
    _, expq_next = _policy_logp_and_expq(frozen(params["actor"]), target_q, next_obs, draws.get("next"), discrete)
    y = (rew + gamma * (1.0 - dones) * expq_next).detach()
    if discrete:
        q_all = mlp_apply(params["q"], obs)
        q_sa = q_all.gather(-1, acts.long()[:, None])[:, 0]
    else:
        q_sa = mlp_apply(params["q"], torch.cat([obs, acts], -1))[..., 0]
    critic_loss = torch.mean(torch.square(q_sa - y))

    # ---- actor: advantage-filtered regression on dataset a ----
    head, expq = _policy_logp_and_expq(params["actor"], frozen(params["q"]), obs, draws.get("cur"), discrete)
    adv = (q_sa.detach() - expq).detach()
    if binary:
        w = (adv > 0).to(torch.float32)
    else:
        w = torch.clamp(torch.exp(adv / beta), max=wmax)
    if discrete:
        logp = F.log_softmax(head, dim=-1)
        logp_a = logp.gather(-1, acts.long()[:, None])[:, 0]
    else:
        mean, log_std = head
        # Invert tanh squash for dataset actions (in [-1,1]).
        a = torch.clamp(acts, -1 + 1e-6, 1 - 1e-6)
        pre = torch.atanh(a)
        var = torch.exp(2 * log_std)
        # 1 - a^2 + 1e-6 evaluated as written, left to right (the
        # reference's compiled program folds it into (1 + 1e-6) - a^2, which
        # loses ~1.5% of it at the clip: ROADMAP C17).
        logp_a = torch.sum(
            -0.5 * (torch.square(pre - mean) / var + 2 * log_std + LOG_2PI)
            - torch.log(1 - torch.square(a) + 1e-6),
            dim=-1,
        )
    actor_loss = -torch.mean(w * logp_a)
    return critic_loss + actor_loss, {
        "critic_loss": critic_loss,
        "actor_loss": actor_loss,
        "mean_weight": w.mean(),
        "q_mean": q_sa.mean(),
    }


class CRRConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or CRR)
        self.lr = 3e-4
        self.num_rollout_workers = 0
        self.train_batch_size = 256
        self.tau = 5e-3
        self.weight_type = "exp"   # "exp" | "binary" (reference: weight_type)
        self.temperature = 1.0      # beta for exp weights
        self.max_weight = 20.0      # exp-weight clip (reference: max_weight)
        self.n_action_samples = 4   # continuous: samples for E_pi[Q]
        self.updates_per_iter = 200
        self.input_: Optional[object] = None
        self.model_hiddens = (256, 256)

    def offline_data(self, *, input_=None, input_reader_kwargs=None) -> "CRRConfig":
        if input_ is not None:
            self.input_ = input_
        if input_reader_kwargs is not None:
            self.input_reader_kwargs = dict(input_reader_kwargs)
        return self

    def training(self, *, tau=None, weight_type=None, temperature=None,
                 max_weight=None, n_action_samples=None, updates_per_iter=None,
                 **kwargs) -> "CRRConfig":
        super().training(**kwargs)
        for name, val in (
            ("tau", tau), ("weight_type", weight_type), ("temperature", temperature),
            ("max_weight", max_weight), ("n_action_samples", n_action_samples),
            ("updates_per_iter", updates_per_iter),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class CRR(OffPolicyTraining, Algorithm):
    _target_attr = "target_q"

    @classmethod
    def get_default_config(cls) -> CRRConfig:
        return CRRConfig(cls)

    def setup(self, config: dict) -> None:
        cfg: CRRConfig = self._algo_config
        self.device = _device(cfg.device)  # no card and no device="cpu": raise first
        assert cfg.input_ is not None, "CRR needs offline data: config.offline_data(input_=...)"
        assert cfg.weight_type in ("exp", "binary")
        self.discrete, self.obs_dim, self.action_dim, self._act_scale, self._act_offset = env_spaces(cfg)
        self.reader = make_input_reader(
            cfg.input_, gamma=cfg.gamma, seed=cfg.seed,
            **cfg.input_reader_kwargs,
        )
        gen = torch.Generator().manual_seed(int(cfg.seed))
        H = cfg.model_hiddens
        if self.discrete:
            params = {
                "actor": mlp_params(gen, self.obs_dim, H, self.action_dim),
                "q": mlp_params(gen, self.obs_dim, H, self.action_dim),
            }
        else:
            params = {
                # Squashed Gaussian head: mean + log_std.
                "actor": mlp_params(gen, self.obs_dim, H, 2 * self.action_dim),
                "q": mlp_params(gen, self.obs_dim + self.action_dim, H, 1),
            }
        self.params = trainable(params, self.device)
        self.target_q = tree_map(lambda t: t.detach().clone(), self.params["q"])
        self.opt = OptaxChain(tree_leaves(self.params), cfg.lr)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._timesteps_total = 0

    def _update_draws(self, n: int) -> dict:
        """One update's draws (continuous; none when discrete): the
        expectation's samples at s' (the bootstrap) and at s (the actor)."""
        if self.discrete:
            return {}
        shape = (self._algo_config.n_action_samples, n, self.action_dim)
        return {k: torch.randn(shape, generator=self._gen, device=self.device) for k in ("next", "cur")}

    def loss_and_grads(self, batch: dict, draws: dict):
        cfg: CRRConfig = self._algo_config
        with full_f32(self.device):
            total, aux = crr_loss(self.params, self.target_q, batch, draws, discrete=self.discrete,
                                  gamma=cfg.gamma, beta=cfg.temperature, wmax=cfg.max_weight,
                                  binary=cfg.weight_type == "binary")
            grads = torch.autograd.grad(total, tree_leaves(self.params))
        return total, aux, grads

    def update(self, batch: dict, draws: Optional[dict] = None) -> dict:
        """One CRR step from a batch of tensors on the device (the
        reference's jitted ``update``): one Adam step over ``{"actor", "q"}``,
        then ``target_q`` toward the UPDATED critic. Returns the metrics as
        tensors on the device."""
        draws = self._update_draws(batch[OBS].shape[0]) if draws is None else draws
        total, aux, grads = self.loss_and_grads(batch, draws)
        with full_f32(self.device):
            self.opt.step(grads)
        polyak(tree_leaves(self.target_q), tree_leaves(self.params["q"]), self._algo_config.tau)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["total_loss"] = total.detach()
        return aux

    def read_batch(self, batch) -> dict:
        """A reader batch as the update's f32 tensors on the device (as the
        reference casts every column), continuous actions normalised."""
        cols = {k: np.asarray(batch[k], np.float32) for k in (OBS, ACTIONS, REWARDS, DONES, NEXT_OBS)}
        if not self.discrete and self._act_scale is not None:
            cols[ACTIONS] = (cols[ACTIONS] - self._act_offset) / self._act_scale
        return to_device(cols, self.device)

    def training_step(self) -> dict:
        cfg: CRRConfig = self._algo_config
        aux = {}
        for _ in range(cfg.updates_per_iter):
            aux = self.update(self.read_batch(self.reader.next(cfg.train_batch_size)))
            self._timesteps_total += cfg.train_batch_size
        return floats(aux)

    def step(self) -> dict:
        """``OffPolicyTraining.step`` without a reward window: CRR runs no
        env (the reference's result has no ``episode_reward_mean``)."""
        t0 = time.time()
        result = self.training_step()
        result["timesteps_total"] = self._timesteps_total
        result["time_this_iter_s"] = time.time() - t0
        return result

    @torch.no_grad()
    def compute_single_action(self, obs, explore: bool = False):
        x = torch.from_numpy(np.asarray(obs, np.float32).reshape(1, -1)).to(self.device)
        with full_f32(self.device):
            out = mlp_apply(self.params["actor"], x).cpu().numpy()[0]
        if self.discrete:
            return int(out.argmax())
        mean = np.tanh(out[: self.action_dim])
        return mean * self._act_scale + self._act_offset
