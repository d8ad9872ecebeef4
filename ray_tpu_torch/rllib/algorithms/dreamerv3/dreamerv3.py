"""DreamerV3 — model-based RL: RSSM world model + actor-critic trained in
imagination (Hafner et al. 2023).

Reference: rllib/algorithms/dreamerv3/ (torch/tf world-model + dreamed
trajectories). One update learns the world model over a sequence (a loop over
time), steps it, then rolls the actor H steps through the UPDATED dynamics
(a loop over the horizon), computes lambda-returns (a reverse loop) and both
actor and critic losses; everything runs on the config's device (the card by
default) in full f32 (``full_f32``), the env on the host.

Core recipe kept from the paper, sized for small control tasks:
- RSSM with categorical latents (``latent_groups`` x ``latent_classes``),
  straight-through gradients, GRU deterministic path.
- symlog squashing for observation/reward/value regression targets.
- KL balancing (dyn vs rep) with free bits.
- Imagination actor-critic: continuous actors backprop straight through
  the (differentiable) dynamics; discrete actors use straight-through
  one-hot samples. EMA critic provides bootstrap targets; returns are
  scaled by an EMA 5-95 percentile range (the paper's robust normalizer).

Gradient scope: the world model is stepped on its own loss first; the actor
and critic losses are then differentiated with ``torch.autograd.grad`` over the
actor's and the critic's leaves only, so the world model's tensors receive no
gradient from them although the actor's gradient flows through the
dynamics. Every ``stop_gradient`` of the reference is a ``detach`` in the same
place.

Draws: ``jax.random.categorical`` is ``argmax(logits + Gumbel)``, so every
categorical draw (the posterior and prior latents, the discrete actor) takes
Gumbel noise of the logits' shape, and the continuous actor standard
normals. ``world_loss``, ``imagine``, ``ac_loss``, ``policy_step`` and
:meth:`DreamerV3.update` take them as explicit tensors; the algorithm draws
them from a ``torch.Generator`` seeded with ``seed + 1`` on its device.
Initial weights are draws of the port's own from a CPU generator seeded with
``seed`` (``dreamerv3_params_from_jax`` carries the reference's across).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.off_policy import OffPolicyTraining, floats, mlp_apply, mlp_params
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32, global_norm, to_device
from ray_tpu_torch.rllib.core.rl_module import _device, copy_into, host_tree, tree_leaves, tree_map


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * torch.expm1(torch.abs(x))


def gru_params(gen, in_dim, hidden):
    """``wx`` [in, 3h] and ``wh`` [h, 3h] uniform in +-1/sqrt(in + h) from the
    CPU generator ``gen``, ``b`` zero (the reference's shapes and bounds)."""
    scale = 1.0 / np.sqrt(in_dim + hidden)

    def mat(shape):
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * scale

    return {"wx": mat((in_dim, 3 * hidden)), "wh": mat((hidden, 3 * hidden)), "b": torch.zeros(3 * hidden)}


def gru_apply(p, x, h):
    """The reference's GRU cell (not ``torch.nn.GRU``'s layout): one fused
    product for the three gates, then the candidate's recurrent term gated by
    the reset gate, ``tanh(c + (r - 1) * (h @ W_c))``."""
    hidden = h.shape[-1]
    hw = h @ p["wh"]
    gates = x @ p["wx"] + hw + p["b"]
    r, u, c = gates.split(hidden, dim=-1)
    r = torch.sigmoid(r)
    u = torch.sigmoid(u)
    c = torch.tanh(c + (r - 1.0) * hw[..., 2 * hidden:])
    return u * h + (1.0 - u) * c


def gumbel(shape, generator, device):
    """Standard Gumbel draws, ``-log(-log(U))`` with U uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_latent(logits, noise, groups: int, classes: int):
    """Straight-through categorical sample per group, with the paper's 1%
    uniform mix for non-degenerate KLs: (the flattened sample, the log-probs
    [..., G, C]). ``noise``: Gumbel draws [..., G, C]; None draws nothing and
    gives the log-probs only."""
    logits = logits.reshape(logits.shape[:-1] + (groups, classes))
    probs = 0.99 * torch.softmax(logits, dim=-1) + 0.01 / classes
    logp = torch.log(probs)
    if noise is None:
        return None, logp
    onehot = F.one_hot((logp + noise).argmax(-1), classes).to(probs.dtype)
    st = onehot + probs - probs.detach()
    return st.reshape(st.shape[:-2] + (groups * classes,)), logp


def kl(lp_a, lp_b):
    """KL(a || b) for grouped categoricals given log-probs [., G, C]."""
    return (torch.exp(lp_a) * (lp_a - lp_b)).sum(-1).sum(-1)


def obs_step(params, h, z, a_prev, embed, is_first, noise, groups, classes):
    """One posterior step: reset the carry where ``is_first``, advance the
    GRU, and sample the posterior latent with the Gumbel ``noise``. Returns
    (h, z, the posterior's log-probs). The prior at h draws nothing and feeds
    only the KL: ``world_loss`` applies it to every step's h at once after its
    loop, and acting does not need it."""
    first = (is_first != 0)[:, None]
    h = torch.where(first, torch.zeros_like(h), h)
    z = torch.where(first, torch.zeros_like(z), z)
    a_prev = torch.where(first, torch.zeros_like(a_prev), a_prev)
    x = F.silu(mlp_apply(params["gru_in"], torch.cat([z, a_prev], -1)))
    h = gru_apply(params["gru"], x, h)
    post_logits = mlp_apply(params["post"], torch.cat([h, embed], -1))
    z_new, post_lp = sample_latent(post_logits, noise, groups, classes)
    return h, z_new, post_lp


def actor_dist(actor_params, feat, discrete: bool):
    out = mlp_apply(actor_params["pi"], feat)
    if discrete:
        return out  # logits
    mean, log_std = out.chunk(2, dim=-1)
    return torch.tanh(mean), torch.clamp(log_std, -4.0, 1.0)


def actor_sample(actor_params, feat, draw, discrete: bool, act_dim: int):
    """Differentiable action sample + entropy; ``draw`` is Gumbel noise of
    the logits' shape (discrete) or standard normals of the mean's."""
    if discrete:
        logits = actor_dist(actor_params, feat, True)
        probs = torch.softmax(logits, dim=-1)
        onehot = F.one_hot((logits + draw).argmax(-1), act_dim).to(probs.dtype)
        a = onehot + probs - probs.detach()
        ent = -(probs * F.log_softmax(logits, dim=-1)).sum(-1)
        return a, ent
    mean, log_std = actor_dist(actor_params, feat, False)
    a = mean + torch.exp(log_std) * draw
    ent = (0.5 * math.log(2 * math.pi * math.e) + log_std).sum(-1)
    return torch.clamp(a, -1.0, 1.0), ent


def world_loss(params, batch, noise, cfg):
    """(loss, aux) of the world model over a ``[B, L]`` batch of tensors;
    ``noise``: the posterior latents' Gumbel draws [L, B, G, C]. aux holds the
    four metrics and the detached ``states`` (h, z) [B, L, ...]."""
    G, C = cfg.latent_groups, cfg.latent_classes
    B, L = batch["obs"].shape[:2]
    obs_sym = symlog(batch["obs"])
    embeds = F.silu(mlp_apply(params["encoder"], obs_sym.reshape(B * L, -1))).reshape(B, L, -1)
    # Arrival convention: row t already stores the action that led INTO
    # obs_t, so the reward/cont heads at state s_t regress quantities s_t can
    # actually explain (r received on arrival, terminality of obs_t) —
    # matching how imagination reads them at the NEXT state.
    a_prev = batch["actions"]
    D = params["gru"]["wh"].shape[0]
    h = torch.zeros(B, D, device=a_prev.device)
    z = torch.zeros(B, G * C, device=a_prev.device)
    hs, zs, post_lps = [], [], []
    for t in range(L):
        h, z, post_lp = obs_step(params, h, z, a_prev[:, t], embeds[:, t], batch["is_first"][:, t], noise[t], G, C)
        hs.append(h)
        zs.append(z)
        post_lps.append(post_lp)
    hs, zs, post_lps = torch.stack(hs, 1), torch.stack(zs, 1), torch.stack(post_lps, 1)
    _, prior_lps = sample_latent(mlp_apply(params["prior"], hs), None, G, C)
    feat = torch.cat([hs, zs], -1)

    obs_hat = mlp_apply(params["decoder"], feat)
    recon = 0.5 * ((obs_hat - obs_sym) ** 2).sum(-1)
    rew_hat = mlp_apply(params["reward"], feat)[..., 0]
    rew_loss = 0.5 * (rew_hat - symlog(batch["rewards"])) ** 2
    cont_logit = mlp_apply(params["cont"], feat)[..., 0]
    cont_loss = -(
        batch["cont"] * F.logsigmoid(cont_logit)
        + (1 - batch["cont"]) * F.logsigmoid(-cont_logit)
    )
    dyn = torch.clamp(kl(post_lps.detach(), prior_lps), min=cfg.free_bits)
    rep = torch.clamp(kl(post_lps, prior_lps.detach()), min=cfg.free_bits)
    loss = (recon + rew_loss + cont_loss + cfg.kl_dyn_scale * dyn + cfg.kl_rep_scale * rep).mean()
    aux = {
        "model_loss": loss, "recon_loss": recon.mean(),
        "reward_loss": rew_loss.mean(), "kl_dyn": dyn.mean(),
        "states": (hs.detach(), zs.detach()),
    }
    return loss, aux


def imagine(params, actor_params, h0, z0, draws, cfg, discrete: bool, act_dim: int):
    """Roll the PRIOR forward H steps driven by the actor; fully
    differentiable for dynamics-backprop actor gradients. ``draws``:
    ``{"action": [H, N, A], "latent": [H, N, G, C]}``. Returns the features
    [H+1, N, feat] (the start's first) and the entropies [H, N]."""
    G, C = cfg.latent_groups, cfg.latent_classes
    h, z = h0, z0
    hs, zs, ents = [], [], []
    for a_draw, z_draw in zip(draws["action"], draws["latent"]):
        a, ent = actor_sample(actor_params, torch.cat([h, z], -1), a_draw, discrete, act_dim)
        x = F.silu(mlp_apply(params["gru_in"], torch.cat([z, a], -1)))
        h = gru_apply(params["gru"], x, h)
        z, _ = sample_latent(mlp_apply(params["prior"], h), z_draw, G, C)
        hs.append(h)
        zs.append(z)
        ents.append(ent)
    feat = torch.cat([torch.stack(hs), torch.stack(zs)], -1)
    feat0 = torch.cat([h0, z0], -1)[None]
    return torch.cat([feat0, feat], 0), torch.stack(ents)


def lambda_returns(rewards, conts, values, gamma: float, lambda_: float):
    """values[t] bootstraps; a reverse loop over the H steps -> [H, N]."""
    carry = values[-1]
    rets = []
    for t in range(len(rewards) - 1, -1, -1):
        carry = rewards[t] + gamma * conts[t] * ((1 - lambda_) * values[t + 1] + lambda_ * carry)
        rets.append(carry)
    return torch.stack(rets[::-1])


def ac_loss(actor_params, critic_params, params, critic_ema, states, scale, draws, cfg, discrete: bool,
            act_dim: int):
    """(actor loss + critic loss, aux) from the world model's detached
    ``states``, imagined with ``draws`` (see :func:`imagine`); aux holds the
    metrics and the updated return scale."""
    hs, zs = states
    h0 = hs.reshape(-1, hs.shape[-1])
    z0 = zs.reshape(-1, zs.shape[-1])
    feats, ents = imagine(params, actor_params, h0, z0, draws, cfg, discrete, act_dim)  # [H+1,N,f]
    rew = symexp(mlp_apply(params["reward"], feats)[..., 0])[1:]  # [H,N]
    cont = torch.sigmoid(mlp_apply(params["cont"], feats)[..., 0])[1:]
    v_ema = symexp(mlp_apply(critic_ema["v"], feats)[..., 0])  # [H+1,N]
    rets = lambda_returns(rew, cont, v_ema, cfg.gamma, cfg.lambda_)  # [H, N]
    # Discount weights: imagination beyond a predicted episode end shouldn't
    # carry gradient weight.
    weights = torch.cat([torch.ones_like(cont[:1]), torch.cumprod(cont[:-1], 0)], 0).detach()
    # Actor: maximize normalized return (grads flow through the dynamics
    # into the actions) + entropy bonus.
    norm_rets = rets / torch.clamp(scale, min=1.0)
    actor_loss = -(weights * norm_rets).mean() - cfg.entropy_coeff * (weights * ents).mean()
    # Critic regresses symlog(lambda-return) on sg(features).
    v_pred = mlp_apply(critic_params["v"], feats[:-1].detach())[..., 0]
    critic_loss = (0.5 * weights * (v_pred - symlog(rets).detach()) ** 2).mean()
    # Robust return scale update (5-95 percentile range EMA); torch.quantile
    # interpolates linearly, as jnp.percentile does.
    flat = rets.detach().reshape(-1)
    rng = torch.quantile(flat, 0.95) - torch.quantile(flat, 0.05)
    new_scale = cfg.return_norm_decay * scale + (1 - cfg.return_norm_decay) * rng
    aux = {
        "actor_loss": actor_loss, "critic_loss": critic_loss,
        "imagined_return": rets.mean(), "actor_entropy": ents.mean(),
        "return_scale": new_scale,
    }
    return actor_loss + critic_loss, aux


def policy_step(params, actor_params, h, z, a_prev, obs, is_first, draws, explore: bool, cfg, discrete: bool,
                act_dim: int):
    """One acting step: the posterior with ``draws["latent"]`` (Gumbel [N, G,
    C]), then the action, sampled with ``draws["action"]`` when ``explore``.
    Returns (h, z, the action as stored, the env's action)."""
    embed = F.silu(mlp_apply(params["encoder"], symlog(obs)))
    h, z, _ = obs_step(params, h, z, a_prev, embed, is_first, draws["latent"], cfg.latent_groups,
                       cfg.latent_classes)
    feat = torch.cat([h, z], -1)
    if discrete:
        logits = actor_dist(actor_params, feat, True)
        a_env = (logits + draws["action"]).argmax(-1) if explore else logits.argmax(-1)
        return h, z, F.one_hot(a_env, act_dim).to(logits.dtype), a_env
    mean, log_std = actor_dist(actor_params, feat, False)
    a = torch.clamp(mean + draws["action"] * torch.exp(log_std) if explore else mean, -1.0, 1.0)
    return h, z, a, a


def dreamerv3_params_from_jax(tree, *, device="cuda"):
    """The reference's world model (``params``), actor, critic or critic EMA
    tree (numpy leaves, as ``jax.tree_util.tree_map(np.asarray, ...)`` gives
    them), or a dict of several, as the port's f32 tensors on ``device``: the
    layouts agree (dense ``{"w": [din, dout], "b"}``, the GRU's ``wx``, ``wh``,
    ``b``), the leaves copy as they are."""
    dev = _device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev), tree)


class DreamerV3Config(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DreamerV3)
        self.lr = 4e-4
        self.actor_lr = 1e-4
        self.critic_lr = 1e-4
        self.num_rollout_workers = 0  # the env steps in this process
        # World model size.
        self.deter_size = 128
        self.latent_groups = 8
        self.latent_classes = 8
        self.model_hiddens = (128,)
        # Sequence replay.
        self.replay_capacity = 100_000
        self.batch_size = 8
        self.batch_length = 16
        self.learning_starts = 500
        self.rollout_steps_per_iter = 250
        self.train_intensity = 8  # env steps per model/actor/critic update
        # Losses.
        self.kl_dyn_scale = 0.5
        self.kl_rep_scale = 0.1
        self.free_bits = 1.0
        # Imagination.
        self.imagine_horizon = 10
        self.lambda_ = 0.95
        self.entropy_coeff = 3e-3
        self.critic_ema_decay = 0.98
        self.return_norm_decay = 0.99

    def training(self, *, actor_lr=None, critic_lr=None, deter_size=None,
                 latent_groups=None, latent_classes=None, replay_capacity=None,
                 batch_size=None, batch_length=None, learning_starts=None,
                 rollout_steps_per_iter=None, train_intensity=None,
                 kl_dyn_scale=None, kl_rep_scale=None, free_bits=None,
                 imagine_horizon=None, entropy_coeff=None,
                 critic_ema_decay=None, **kwargs) -> "DreamerV3Config":
        super().training(**kwargs)
        for name, value in (
            ("actor_lr", actor_lr), ("critic_lr", critic_lr),
            ("deter_size", deter_size), ("latent_groups", latent_groups),
            ("latent_classes", latent_classes), ("replay_capacity", replay_capacity),
            ("batch_size", batch_size), ("batch_length", batch_length),
            ("learning_starts", learning_starts),
            ("rollout_steps_per_iter", rollout_steps_per_iter),
            ("train_intensity", train_intensity),
            ("kl_dyn_scale", kl_dyn_scale), ("kl_rep_scale", kl_rep_scale),
            ("free_bits", free_bits), ("imagine_horizon", imagine_horizon),
            ("entropy_coeff", entropy_coeff), ("critic_ema_decay", critic_ema_decay),
        ):
            if value is not None:
                setattr(self, name, value)
        return self


class _SequenceReplay:
    """Ring buffer of ARRIVAL-convention rows (the paper's replay layout):
    row t holds (obs_t, action that LED to obs_t, reward received on
    arrival, cont_t = 0 iff obs_t is terminal, is_first). Episode starts
    store the reset observation with zero action/reward. Samples [B, L]
    subsequences; crossing episode boundaries is fine — IS_FIRST resets
    the RSSM state inside the loop over time."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int, seed: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity, act_dim), np.float32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.cont = np.ones((capacity,), np.float32)  # 1 - terminated
        self.is_first = np.zeros((capacity,), np.float32)
        self._n = 0
        self._idx = 0
        self._rng = np.random.default_rng(seed)

    def add(self, obs, action, reward, terminated, is_first):
        i = self._idx
        self.obs[i] = obs
        self.actions[i] = action
        self.rewards[i] = reward
        self.cont[i] = 0.0 if terminated else 1.0
        self.is_first[i] = 1.0 if is_first else 0.0
        self._idx = (i + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)

    def __len__(self):
        return self._n

    def sample(self, batch_size: int, length: int) -> dict:
        assert self._n >= length, "not enough steps buffered"
        starts = self._rng.integers(0, self._n - length + 1, batch_size)
        if self._n == self.capacity:
            # Full ring: logical order starts at the write head; mapping
            # through it keeps sampled windows contiguous-in-time even when
            # they cross the physical wrap point.
            starts = (starts + self._idx) % self.capacity
        idx = (starts[:, None] + np.arange(length)[None, :]) % self.capacity  # [B, L]
        out = {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "cont": self.cont[idx],
            "is_first": self.is_first[idx].copy(),
        }
        # The first sampled step has no in-buffer predecessor context; treat
        # it as a sequence start so stale carry never leaks in.
        out["is_first"][:, 0] = 1.0
        return out


class DreamerV3(OffPolicyTraining, Algorithm):
    @classmethod
    def get_default_config(cls) -> DreamerV3Config:
        return DreamerV3Config(cls)

    # -- setup -----------------------------------------------------------
    def setup(self, config: dict) -> None:
        self.cleanup()
        cfg: DreamerV3Config = self._algo_config
        self.device = dev = _device(cfg.device)  # no card and no device="cpu": raise before the env
        from ray_tpu_torch.rllib.env.cartpole import make

        self.env = make(cfg.env) if isinstance(cfg.env, str) else cfg.env(dict(cfg.env_config))
        obs_space, act_space = self.env.observation_space, self.env.action_space
        self.obs_dim = int(np.prod(obs_space.shape))
        self.discrete = not hasattr(act_space, "low")
        if self.discrete:
            self.act_dim = int(act_space.n)
            self._act_scale = self._act_offset = None
        else:
            self.act_dim = int(np.prod(act_space.shape))
            low = np.asarray(act_space.low, np.float32).ravel()
            high = np.asarray(act_space.high, np.float32).ravel()
            self._act_scale = (high - low) / 2.0
            self._act_offset = (high + low) / 2.0

        G, C, D = cfg.latent_groups, cfg.latent_classes, cfg.deter_size
        self.latent_dim = G * C
        feat_dim = D + self.latent_dim
        H = tuple(cfg.model_hiddens)
        gen = torch.Generator().manual_seed(int(cfg.seed))
        params = {
            "encoder": mlp_params(gen, self.obs_dim, H, H[-1]),
            "gru_in": mlp_params(gen, self.latent_dim + self.act_dim, (), D),
            "gru": gru_params(gen, D, D),
            "prior": mlp_params(gen, D, H, self.latent_dim),
            "post": mlp_params(gen, D + H[-1], H, self.latent_dim),
            "decoder": mlp_params(gen, feat_dim, H, self.obs_dim),
            "reward": mlp_params(gen, feat_dim, H, 1),
            "cont": mlp_params(gen, feat_dim, H, 1),
        }
        actor = {"pi": mlp_params(gen, feat_dim, H, self.act_dim if self.discrete else 2 * self.act_dim)}
        critic = {"v": mlp_params(gen, feat_dim, H, 1)}
        self.params, self.actor_params, self.critic_params = (
            tree_map(lambda t: t.to(dev).requires_grad_(True), tree) for tree in (params, actor, critic))
        self.critic_ema = tree_map(lambda t: t.detach().clone(), self.critic_params)

        self.opt = {
            "model": OptaxChain(tree_leaves(self.params), cfg.lr, grad_clip=100.0),
            "actor": OptaxChain(tree_leaves(self.actor_params), cfg.actor_lr, grad_clip=100.0),
            "critic": OptaxChain(tree_leaves(self.critic_params), cfg.critic_lr, grad_clip=100.0),
        }
        # EMA of the 5-95 return percentile range (robust scale).
        self.return_scale = torch.ones((), device=dev)

        self.buffer = _SequenceReplay(cfg.replay_capacity, self.obs_dim, self.act_dim, cfg.seed)
        self._gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        self._timesteps_total = 0
        self._updates = 0
        self._episode_reward_window: list = []
        self._first_flags = (torch.zeros(1, device=dev), torch.ones(1, device=dev))

        # Live env state: obs + RSSM carry for acting (on the device).
        obs, _ = self.env.reset(seed=cfg.seed)
        self._obs = np.asarray(obs, np.float32).ravel()
        self._carry = (torch.zeros(1, D, device=dev), torch.zeros(1, self.latent_dim, device=dev))
        self._a_prev = torch.zeros(1, self.act_dim, device=dev)
        self._ep_reward = 0.0
        self._ep_first = True
        # Arrival-convention row for the reset observation.
        self.buffer.add(self._obs, np.zeros(self.act_dim, np.float32), 0.0, False, True)

    # -- draws -------------------------------------------------------------
    def _action_draws(self, *rows):
        shape = rows + (self.act_dim,)
        if self.discrete:
            return gumbel(shape, self._gen, self.device)
        return torch.randn(shape, generator=self._gen, device=self.device)

    def _latent_draws(self, *rows):
        cfg = self._algo_config
        return gumbel(rows + (cfg.latent_groups, cfg.latent_classes), self._gen, self.device)

    def _update_draws(self, B: int, L: int) -> dict:
        """One update's draws: the posterior latents over the sequence [L, B,
        G, C], then imagination's actions [H, B*L, A] and prior latents [H,
        B*L, G, C] (the reference's ``k1``, ``k2``)."""
        H = self._algo_config.imagine_horizon
        return {"world": self._latent_draws(L, B), "action": self._action_draws(H, B * L),
                "latent": self._latent_draws(H, B * L)}

    # -- the update ----------------------------------------------------------
    def train_step(self, batch, draws: Optional[dict] = None):
        """One update (the reference's jitted ``update``): the world model's
        loss, gradients and Adam step; then the actor and critic losses through
        the UPDATED world model, their gradients over the actor's and the
        critic's leaves only, and their Adam steps; the critic EMA toward the
        updated critic; the new return scale. Returns (the metrics as tensors
        on the device, the gradients: the world model's, the actor's, the
        critic's, each in its tree's leaf order)."""
        cfg: DreamerV3Config = self._algo_config
        tb = to_device(batch, self.device)
        B, L = tb["obs"].shape[:2]
        draws = self._update_draws(B, L) if draws is None else draws
        with full_f32(self.device):
            m_loss, m_aux = world_loss(self.params, tb, draws["world"], cfg)
            m_grads = torch.autograd.grad(m_loss, tree_leaves(self.params))
            self.opt["model"].step(m_grads, global_norm(m_grads))
            total, a_aux = ac_loss(self.actor_params, self.critic_params, self.params, self.critic_ema,
                                   m_aux["states"], self.return_scale, draws, cfg, self.discrete, self.act_dim)
            a_leaves, c_leaves = tree_leaves(self.actor_params), tree_leaves(self.critic_params)
            grads = torch.autograd.grad(total, a_leaves + c_leaves)
            a_grads, c_grads = grads[:len(a_leaves)], grads[len(a_leaves):]
            self.opt["actor"].step(a_grads, global_norm(a_grads))
            self.opt["critic"].step(c_grads, global_norm(c_grads))
            with torch.no_grad():
                d = cfg.critic_ema_decay
                ema = tree_leaves(self.critic_ema)
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, torch._foreach_mul([p.detach() for p in c_leaves], 1 - d))
        self.return_scale = a_aux["return_scale"].detach()
        self._updates += 1
        metrics = {k: m_aux[k].detach() for k in ("model_loss", "recon_loss", "reward_loss", "kl_dyn")}
        metrics.update({k: a_aux[k].detach() for k in ("actor_loss", "critic_loss", "imagined_return",
                                                        "actor_entropy")})
        return metrics, list(m_grads) + list(a_grads) + list(c_grads)

    def update(self, batch, draws: Optional[dict] = None) -> dict:
        """:meth:`train_step`'s metrics (tensors on the device, no host sync)."""
        return self.train_step(batch, draws)[0]

    # -- acting ----------------------------------------------------------
    def _act(self, explore: bool = True):
        cfg: DreamerV3Config = self._algo_config
        draws = {"latent": self._latent_draws(1), "action": self._action_draws(1)}
        h, z = self._carry
        with torch.no_grad(), full_f32(self.device):
            obs = torch.from_numpy(self._obs[None]).to(self.device)
            h, z, a_store, _ = policy_step(self.params, self.actor_params, h, z, self._a_prev, obs,
                                           self._first_flags[int(self._ep_first)], draws, explore, cfg,
                                           self.discrete, self.act_dim)
        self._carry = (h, z)
        self._a_prev = a_store
        a_store = a_store.cpu().numpy()[0]  # the step's one read
        if self.discrete:
            return a_store, int(a_store.argmax())
        env_a = a_store * self._act_scale + self._act_offset
        return a_store, env_a.reshape(self.env.action_space.shape)

    def _reset_carry(self) -> None:
        self._carry = (torch.zeros_like(self._carry[0]), torch.zeros_like(self._carry[1]))
        self._a_prev = torch.zeros_like(self._a_prev)

    # -- Trainable protocol ---------------------------------------------
    def training_step(self) -> dict:
        cfg: DreamerV3Config = self._algo_config
        metrics: dict = {}
        for _ in range(cfg.rollout_steps_per_iter):
            a_store, a_env = self._act(explore=True)
            obs2, r, term, trunc, _ = self.env.step(a_env)
            # Arrival row: the observation we LANDED in, the action that
            # took us there, the reward received, and its terminality —
            # this keeps the reward/cont heads predictable from the state
            # that contains the causing action (paper's replay layout).
            self.buffer.add(
                np.asarray(obs2, np.float32).ravel(), a_store, float(r), term, False
            )
            self._ep_first = False
            self._ep_reward += float(r)
            self._timesteps_total += 1
            if term or trunc:
                self._episode_reward_window.append(self._ep_reward)
                self._episode_reward_window = self._episode_reward_window[-100:]
                self._ep_reward = 0.0
                obs2, _ = self.env.reset()
                self._reset_carry()
                self._ep_first = True
                self.buffer.add(
                    np.asarray(obs2, np.float32).ravel(),
                    np.zeros(self.act_dim, np.float32), 0.0, False, True,
                )
            self._obs = np.asarray(obs2, np.float32).ravel()
            if (
                len(self.buffer) >= max(cfg.learning_starts, cfg.batch_length + 1)
                and self._timesteps_total % max(1, cfg.train_intensity) == 0
            ):
                metrics = self.update(self.buffer.sample(cfg.batch_size, cfg.batch_length))
        return floats(metrics)

    def compute_single_action(self, obs, explore: bool = False):
        """Greedy action through a TRANSIENT RSSM carry (does not disturb
        the training rollout's live carry)."""
        saved = (self._carry, self._obs, self._ep_first, self._a_prev)
        try:
            self._obs = np.asarray(obs, np.float32).ravel()
            self._ep_first = True  # no history for a one-shot query
            self._reset_carry()
            _, a_env = self._act(explore=explore)
            return a_env
        finally:
            self._carry, self._obs, self._ep_first, self._a_prev = saved

    def _evaluate_local(self, duration: int, by_episodes: bool):
        """Greedy episodes with a PERSISTENT RSSM carry across each episode
        (the base loop's stateless compute_single_action would wipe the
        world-model memory every step)."""
        env = self._make_eval_env()
        saved = (self._carry, self._obs, self._ep_first, self._a_prev)
        rewards, lens, steps = [], [], 0
        try:
            for _ in range(duration if by_episodes else 64):
                obs, _ = env.reset()
                self._obs = np.asarray(obs, np.float32).ravel()
                self._ep_first = True
                self._reset_carry()
                total, length = 0.0, 0
                for _ in range(10_000):
                    _, a_env = self._act(explore=False)
                    self._ep_first = False
                    obs, r, terminated, truncated, _ = env.step(a_env)
                    self._obs = np.asarray(obs, np.float32).ravel()
                    total += float(r)
                    length += 1
                    steps += 1
                    if terminated or truncated:
                        break
                    if not by_episodes and steps >= duration:
                        break
                rewards.append(total)
                lens.append(length)
                if not by_episodes and steps >= duration:
                    break
        finally:
            self._carry, self._obs, self._ep_first, self._a_prev = saved
            try:
                env.close()
            except Exception:
                pass
        return rewards, lens

    def save_checkpoint(self):
        """The reference's keys, plus the device generator's state."""
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict({
            "params": host_tree(self.params),
            "actor": host_tree(self.actor_params),
            "critic": host_tree(self.critic_params),
            "critic_ema": host_tree(self.critic_ema),
            "return_scale": float(self.return_scale),
            "timesteps": self._timesteps_total,
            "updates": self._updates,
            "rng": self._gen.get_state().numpy().copy(),
        })

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        for name, key in (("params", "params"), ("actor_params", "actor"), ("critic_params", "critic"),
                          ("critic_ema", "critic_ema")):
            copy_into(getattr(self, name), data[key])
        self.return_scale = torch.tensor(data["return_scale"], dtype=torch.float32, device=self.device)
        self._timesteps_total = data.get("timesteps", 0)
        self._updates = data.get("updates", 0)
        if "rng" in data:
            self._gen.set_state(torch.from_numpy(np.array(data["rng"], np.uint8)))

    def get_policy_weights(self):
        return {"actor": host_tree(self.actor_params), "model": host_tree(self.params)}
