"""SlateQ — Q-learning for slate recommendation (Ie et al. 2019).

Reference: rllib/algorithms/slateq/ (slateq.py, slateq_torch_policy.py):
the combinatorial slate action space is made tractable by SlateQ's
DECOMPOSITION under a conditional-logistic user choice model:

    Q(s, slate) = sum_i P(click i | s, slate) * q(s, d_i)

where q(s, d) is a learned per-DOCUMENT Q-value and the click
probabilities come from a choice model with learned user/doc affinity
scores. The TD target bootstraps with the best next slate, found by the
reference's default greedy optimizer (top-k by v(s,d)*q(s,d) score — exact
for this choice-model family). Both the per-item q-network and the choice
model's affinity head train jointly: q by SARSA-style decomposed TD on
clicked items, the choice model by maximum likelihood on observed clicks.

Candidates are a [C, F] tensor; per-item q and affinity are batched matmuls
over all candidates at once, and the greedy slate is a top-k. The update and
the greedy slate run on the config's device (the card unless it asks for the
CPU); the env, the epsilon draws and the replay stay on the host. The two
heads step through two Adams (``q`` at ``lr``, ``choice`` at ``choice_lr``:
the reference's ``optax.multi_transform``). The top-k is a stable descending
sort, so equal scores seat the lower candidate index first on either device,
as ``jax.lax.top_k`` does (``torch.topk`` does not promise an order for
ties). The MLPs are ``off_policy``'s (glorot-uniform from a CPU
``torch.Generator``): the port's initial weights are its own, and
``slateq_params_from_jax`` carries the reference's across.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.off_policy import (
    OffPolicyTraining,
    floats,
    mlp_apply,
    mlp_params,
    mlp_params_from_jax,
)
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32
from ray_tpu_torch.rllib.core.rl_module import _device, copy_into, tree_leaves, tree_map
from ray_tpu_torch.rllib.env.recsys import SlateRecEnv
from ray_tpu_torch.rllib.utils.replay_buffers import ColumnReplayBuffer


def slateq_params_from_jax(params: dict, *, device="cuda") -> dict:
    """The reference's SlateQ params (``q`` and ``choice``: MLPs) as the
    port's tree on ``device``."""
    return {k: mlp_params_from_jax(params[k], device=device) for k in ("q", "choice")}


def per_item(head, user, docs):
    """[B, user] x [B, C, F] -> [B, C] scalars of one head."""
    B, C = docs.shape[0], docs.shape[1]
    inp = torch.cat([user[:, None, :].expand(B, C, user.shape[-1]), docs], -1)
    return mlp_apply(head, inp.reshape(B * C, -1)).reshape(B, C)


def greedy_slate_value(params, user, docs, k: int, no_click: float):
    """(decomposed value of the greedy slate [B], the slate [B, k]): the
    reference's greedy slate optimizer (for conditional-logistic choice, top-k
    by the v*q score is the optimizer's default)."""
    q = per_item(params["q"], user, docs)        # [B,C]
    v = per_item(params["choice"], user, docs)   # [B,C] affinities
    # Ie et al.'s exactness proof for top-k-by-exp(v)*q assumes q >= 0. For
    # q <= 0 the affinity weight inverts the ordering, so positives rank by
    # the proven score and negatives by raw q (least harmful first): every
    # positive item still outranks every negative one.
    score = torch.where(q > 0, torch.exp(v) * q, q)
    top = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]  # [B,K]
    v_top = torch.gather(v, 1, top)
    q_top = torch.gather(q, 1, top)
    w = torch.exp(v_top)
    denom = w.sum(1) + no_click
    return (w * q_top).sum(1) / denom, top


def slateq_loss(params, target_params, batch, *, gamma: float, k: int, no_click: float):
    """(q loss + choice loss, metrics) of one batch of tensors: the clicked
    item's q regressed to the greedy next slate's target value, and the
    choice model's likelihood of the observed click (or no click)."""
    user, docs = batch["user"], batch["docs"]
    slate = batch["slate"].long()      # [B,K]
    clicked = batch["clicked"].long()  # [B] index into slate or -1
    rew, dones = batch["reward"], batch["done"]

    with torch.no_grad():
        next_val, _ = greedy_slate_value(target_params, batch["next_user"], batch["next_docs"], k, no_click)
        y = rew + gamma * (1.0 - dones) * next_val

    # Both heads on the slate's K documents only (the reference scores all C
    # and gathers K: the same rows, a fifth of the work and its backward).
    slate_docs = torch.gather(docs, 1, slate[..., None].expand(-1, -1, docs.shape[-1]))  # [B,K,F]
    q_slate = per_item(params["q"], user, slate_docs)       # [B,K]
    v_slate = per_item(params["choice"], user, slate_docs)
    # --- decomposed TD: regress the CLICKED item's q to y ---
    did_click = clicked >= 0
    safe_click = torch.clamp(clicked, min=0)
    q_clicked = torch.gather(q_slate, 1, safe_click[:, None])[:, 0]
    td = torch.where(did_click, q_clicked - y, torch.zeros_like(y))
    q_loss = torch.sum(torch.square(td)) / torch.clamp(did_click.sum(), min=1)
    # --- choice model: MLE of the observed click/no-click; the no-click
    # logit is the constant log(no_click) (f32, as jnp.log takes it) ---
    no_click_logit = float(np.log(np.float32(no_click)))
    logits = torch.cat([v_slate, torch.full((v_slate.shape[0], 1), no_click_logit, device=v_slate.device)], 1)
    logp = F.log_softmax(logits, dim=-1)
    choice_idx = torch.where(did_click, safe_click, torch.full_like(safe_click, k))  # K = no-click slot
    nll = -torch.gather(logp, 1, choice_idx[:, None])[:, 0]
    choice_loss = nll.mean()
    return q_loss + choice_loss, {
        "q_loss": q_loss,
        "choice_loss": choice_loss,
        "click_rate": did_click.float().mean(),
    }


class SlateQConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SlateQ)
        self.lr = 1e-3
        self.choice_lr = 1e-3
        self.num_rollout_workers = 0
        self.train_batch_size = 64
        self.replay_buffer_capacity = 50_000
        self.learning_starts = 500
        self.target_network_update_freq = 100
        self.rollout_steps_per_iter = 400
        self.train_intensity = 4
        self.epsilon_timesteps = 6000
        self.initial_epsilon = 1.0
        self.final_epsilon = 0.05
        self.model_hiddens = (64, 64)

    def training(self, *, choice_lr=None, replay_buffer_capacity=None,
                 learning_starts=None, target_network_update_freq=None,
                 rollout_steps_per_iter=None, train_intensity=None,
                 epsilon_timesteps=None, final_epsilon=None, **kwargs) -> "SlateQConfig":
        super().training(**kwargs)
        for name, val in (
            ("choice_lr", choice_lr),
            ("replay_buffer_capacity", replay_buffer_capacity),
            ("learning_starts", learning_starts),
            ("target_network_update_freq", target_network_update_freq),
            ("rollout_steps_per_iter", rollout_steps_per_iter),
            ("train_intensity", train_intensity),
            ("epsilon_timesteps", epsilon_timesteps),
            ("final_epsilon", final_epsilon),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class SlateQ(OffPolicyTraining, Algorithm):
    _target_attr = "target_params"

    @classmethod
    def get_default_config(cls) -> SlateQConfig:
        return SlateQConfig(cls)

    def setup(self, config: dict) -> None:
        cfg: SlateQConfig = self._algo_config
        self.device = _device(cfg.device)  # no card and no device="cpu": raise before the env
        env = cfg.env(dict(cfg.env_config)) if callable(cfg.env) else cfg.env
        assert isinstance(env, SlateRecEnv), (
            "SlateQ requires a SlateRecEnv-style slate environment "
            "(user state + candidate docs + slate actions)"
        )
        self.env = env
        self.C = env.num_candidates
        self.K = env.slate_size
        self.F = env.num_topics + 1  # doc features + quality
        self.user_dim = env.num_topics
        self.no_click_mass = env.no_click_mass

        gen = torch.Generator().manual_seed(int(cfg.seed))
        H = cfg.model_hiddens
        # Per-item q(s, d) and choice-affinity v(s, d): both take
        # [user_state, doc_features] and emit a scalar.
        init = {
            "q": mlp_params(gen, self.user_dim + self.F, H, 1),
            "choice": mlp_params(gen, self.user_dim + self.F, H, 1),
        }
        self.params = tree_map(lambda t: t.to(self.device).requires_grad_(True), init)
        self.target_params = tree_map(lambda t: t.detach().clone(), self.params)
        self.opt = {
            "q": OptaxChain(tree_leaves(self.params["q"]), cfg.lr),
            "choice": OptaxChain(tree_leaves(self.params["choice"]), cfg.choice_lr),
        }
        self.buffer = ColumnReplayBuffer(cfg.replay_buffer_capacity, cfg.seed)
        self._timesteps_total = 0
        self._updates = 0
        self._episode_reward_window: list = []
        self._ep_reward = 0.0
        self._np_rng = np.random.default_rng(cfg.seed)
        self._obs, _ = env.reset(seed=cfg.seed)

    # -- obs helpers ----------------------------------------------------

    def _split_obs(self, obs):
        user = obs[..., : self.user_dim]
        docs = obs[..., self.user_dim :].reshape(*obs.shape[:-1], self.C, self.F)
        return user, docs

    def _epsilon(self) -> float:
        cfg = self._algo_config
        frac = min(1.0, self._timesteps_total / max(cfg.epsilon_timesteps, 1))
        return cfg.initial_epsilon + frac * (cfg.final_epsilon - cfg.initial_epsilon)

    @torch.no_grad()
    def greedy_slates(self, user: np.ndarray, docs: np.ndarray) -> np.ndarray:
        """The greedy slates of a batch ([B, user], [B, C, F] -> [B, K]): one
        forward on the device, one read."""
        u = torch.from_numpy(np.require(user, np.float32, "W")).to(self.device)
        d = torch.from_numpy(np.require(docs, np.float32, "W")).to(self.device)
        with full_f32(self.device):
            return greedy_slate_value(self.params, u, d, self.K, self.no_click_mass)[1].cpu().numpy()

    def _pick_slate(self, obs, explore: bool):
        if explore and self._np_rng.random() < self._epsilon():
            return self._np_rng.choice(self.C, self.K, replace=False)
        user, docs = self._split_obs(np.asarray(obs, np.float32))
        return self.greedy_slates(user[None], docs[None])[0]

    def training_step(self) -> dict:
        cfg: SlateQConfig = self._algo_config
        metrics: dict = {}
        for _ in range(cfg.rollout_steps_per_iter):
            obs = self._obs
            slate = self._pick_slate(obs, explore=True)
            nobs, reward, done, _trunc, info = self.env.step(slate)
            user, docs = self._split_obs(np.asarray(obs, np.float32))
            nuser, ndocs = self._split_obs(np.asarray(nobs, np.float32))
            clicked_doc = info.get("clicked", -1)
            clicked_pos = -1
            for pos, doc in enumerate(slate):
                if doc == clicked_doc:
                    clicked_pos = pos
                    break
            self.buffer.add({
                "user": user, "docs": docs, "next_user": nuser, "next_docs": ndocs,
                "slate": np.asarray(slate, np.int32),
                "clicked": np.int32(clicked_pos),
                "reward": np.float32(reward), "done": np.float32(done),
            })
            self._ep_reward += reward
            self._timesteps_total += 1
            if done:
                self._episode_reward_window.append(self._ep_reward)
                self._episode_reward_window = self._episode_reward_window[-100:]
                self._ep_reward = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = nobs
            if (
                len(self.buffer) >= cfg.learning_starts
                and self._timesteps_total % max(1, cfg.train_intensity) == 0
            ):
                metrics = self._train_once()
        metrics["epsilon"] = self._epsilon()
        return metrics

    def loss_and_grads(self, batch: dict):
        """(total loss, metrics, the q head's and the choice head's
        gradients) of one batch of tensors on the device, in full f32."""
        with full_f32(self.device):
            total, aux = slateq_loss(self.params, self.target_params, batch, gamma=self._algo_config.gamma,
                                     k=self.K, no_click=self.no_click_mass)
            grads = torch.autograd.grad(total, self.opt["q"].params + self.opt["choice"].params)
        n_q = len(self.opt["q"].params)
        return total, aux, list(grads[:n_q]), list(grads[n_q:])

    def update(self, batch: dict) -> dict:
        """One SlateQ step (the reference's jitted ``update``) from a host
        batch: each head's gradients stepped by its own Adam. Returns the
        metrics as tensors on the device."""
        tb = {k: torch.from_numpy(np.require(np.asarray(v), requirements="W")).to(self.device)
              for k, v in batch.items()}
        total, aux, q_grads, choice_grads = self.loss_and_grads(tb)
        with full_f32(self.device):
            self.opt["q"].step(q_grads)
            self.opt["choice"].step(choice_grads)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["total_loss"] = total.detach()
        return aux

    def _train_once(self) -> dict:
        cfg = self._algo_config
        aux = self.update(self.buffer.sample(cfg.train_batch_size))
        self._updates += 1
        if self._updates % cfg.target_network_update_freq == 0:
            copy_into(self.target_params, self.params)  # hard sync
        return floats(aux)

    def compute_single_action(self, obs, explore: bool = False):
        return self._pick_slate(obs, explore=explore)
