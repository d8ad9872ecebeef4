"""MBMPO — model-based meta-policy optimization.

Reference: rllib/algorithms/mbmpo/mbmpo.py (Clavera et al. 2018): learn an
ENSEMBLE of dynamics models from real transitions; treat each model as a
"task" and run MAML across the ensemble — inner-adapt the policy inside
each model's imagined MDP, meta-update through the adaptation — so the
policy is robust to model error (the ensemble spread IS the task
distribution). Real env steps are only spent on (a) collecting transitions
to fit the models and (b) the reported true-env return; the PG updates run
on imagined data (mbmpo.py training_step + model_ensemble.py).

On the device (the card by default, in full f32): the ensemble is stacked
``[K, din, dout]`` weights, so its supervised update is one batched program
(batched matmuls over the model axis) with one Adam over the stacked leaves,
not a loop over K models; an imagined rollout steps the policy's forward, its
gaussian draw, the learned dynamics and the env's tensor ``reward_fn`` on the
device, a Python loop over the horizon (the reference's ``lax.scan``); the
MAML machinery is algorithms/maml's :class:`MetaLearner`. Real-env
collection steps the env on the host with the policy's forward on the device.

Draws: the policy noise of real and imagined steps comes from a
``torch.Generator`` seeded with ``seed + 13`` on the device (the reference's
``PRNGKey(seed + 13)``), and ``imagine`` takes it as an explicit tensor. The
dynamics weights are standard normals from a CPU generator seeded with
``seed + 7``; ``mbmpo_dyn_params_from_jax`` carries the reference's across.
"""

from __future__ import annotations

import inspect
import time
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.maml.maml import MAMLConfig, stack_batches
from ray_tpu_torch.rllib.algorithms.off_policy import mlp_params_from_jax
from ray_tpu_torch.rllib.core.learner import OptaxChain, full_f32
from ray_tpu_torch.rllib.core.rl_module import _device, copy_into, gaussian_logp, host_tree, tree_leaves, tree_map
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    DONES,
    LOGPS,
    OBS,
    REWARDS,
    VF_PREDS,
    SampleBatch,
    compute_gae,
)


def dyn_init(gen, n_models, obs_dim, act_dim, hiddens, *, device="cuda"):
    """``n_models`` stacked dynamics MLPs: a list of ``{"w": [K, din, dout],
    "b": [K, dout]}``, ``w`` standard normal times sqrt(2 / din) from the CPU
    generator ``gen``, ``b`` zero; then moved to ``device``."""
    dims = (obs_dim + act_dim,) + tuple(hiddens) + (obs_dim,)
    layers = [{"w": torch.randn(n_models, din, dout, generator=gen) * (2.0 / din) ** 0.5,
               "b": torch.zeros(n_models, dout)} for din, dout in zip(dims[:-1], dims[1:])]
    return tree_map(lambda t: t.to(_device(device)), layers)


def dyn_apply(layers, x):
    """The dynamics MLP (tanh between the layers), predicting ``next_obs -
    obs``. Stacked layers take ``x`` as ``[K, B, din]`` (a batched matmul over
    the model axis); one member's slice takes ``[B, din]``."""
    for layer in layers[:-1]:
        x = torch.tanh(x @ layer["w"] + layer["b"].unsqueeze(-2))
    return x @ layers[-1]["w"] + layers[-1]["b"].unsqueeze(-2)


def mbmpo_dyn_params_from_jax(layers, *, device="cuda") -> list:
    """The reference's stacked ensemble (``dyn_params``: a list of ``{"w":
    [K, din, dout], "b": [K, dout]}`` with numpy leaves) as the port's
    tensors on ``device``: the layouts agree, the leaves copy as they are."""
    return mlp_params_from_jax(layers, device=device)


def ensemble_losses(dyn, obs_k, act_k, nxt_k):
    """Each member's mean squared error on its own bootstrap rows
    (``[K, B, ...]`` inputs): ``[K]``."""
    pred = dyn_apply(dyn, torch.cat([obs_k, act_k], -1))
    return torch.mean((pred - (nxt_k - obs_k)) ** 2, dim=(1, 2))


def ensemble_loss_and_grads(dyn, obs_k, act_k, nxt_k):
    """(each member's loss ``[K]``, the gradients in the stacked leaves'
    order): the gradient of the summed losses, whose slice k is member k's
    own gradient (the reference's ``vmap(value_and_grad)``)."""
    losses = ensemble_losses(dyn, obs_k, act_k, nxt_k)
    return losses.detach(), torch.autograd.grad(losses.sum(), tree_leaves(dyn))


@torch.no_grad()
def imagine(module, params: dict, model, starts, noise, reward):
    """An imagined rollout inside one ensemble member: from ``starts`` [B,
    obs_dim], the policy at ``params`` (parameter name -> tensor) samples
    with the standard-normal ``noise`` [H, B, act_dim] (the reference's key
    split once a step), the clipped action drives ``model``, and
    ``reward(obs, action, next_obs)`` scores it. Returns (obs, actions,
    rewards, logp, vf), each stacked ``[H, B, ...]``."""
    cols = ([], [], [], [], [])
    s = starts
    for eps in noise:
        pi_out, v = torch.func.functional_call(module, params, (s,))
        log_std = params["log_std"] if module.log_std is not None else module._log_std(pi_out)
        a = pi_out + eps * torch.exp(log_std)
        logp = gaussian_logp(a, pi_out, log_std)
        a_clip = torch.clamp(a, -1.0, 1.0)
        nxt = s + dyn_apply(model, torch.cat([s, a_clip], -1))
        for col, x in zip(cols, (s, a, reward(s, a_clip, nxt), logp, v)):
            col.append(x)
        s = nxt
    return tuple(torch.stack(c) for c in cols)


class MBMPOConfig(MAMLConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MBMPO)
        self.ensemble_size = 5
        self.dynamics_hiddens = (64, 64)
        self.dynamics_lr = 1e-3
        self.dynamics_train_epochs = 30
        self.dynamics_batch_size = 256
        self.real_episodes_per_iter = 20
        self.imagined_episodes_per_task = 20
        self.replay_capacity = 20_000
        self.num_rollout_workers = 0  # real-env collection runs in this process

    def training(self, *, ensemble_size: Optional[int] = None,
                 dynamics_hiddens=None, dynamics_lr: Optional[float] = None,
                 dynamics_train_epochs: Optional[int] = None,
                 real_episodes_per_iter: Optional[int] = None,
                 imagined_episodes_per_task: Optional[int] = None, **kwargs) -> "MBMPOConfig":
        super().training(**kwargs)
        for name, val in (
            ("ensemble_size", ensemble_size),
            ("dynamics_hiddens", tuple(dynamics_hiddens) if dynamics_hiddens else None),
            ("dynamics_lr", dynamics_lr),
            ("dynamics_train_epochs", dynamics_train_epochs),
            ("real_episodes_per_iter", real_episodes_per_iter),
            ("imagined_episodes_per_task", imagined_episodes_per_task),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class MBMPO(Algorithm):
    @classmethod
    def get_default_config(cls) -> MBMPOConfig:
        return MBMPOConfig(cls)

    def setup(self, config: dict) -> None:
        self.cleanup()
        cfg: MBMPOConfig = self._algo_config
        self.device = _device(cfg.device)  # no card and no device="cpu": raise before the env
        from ray_tpu_torch.rllib.env.cartpole import make
        from ray_tpu_torch.rllib.models import ModelCatalog

        self.env = make(cfg.env) if isinstance(cfg.env, str) else cfg.env(dict(cfg.env_config))
        reward_fn = getattr(self.env, "reward_fn", None)
        assert reward_fn is not None, (
            "MBMPO needs the env to expose a tensor "
            "reward_fn(obs, action, next_obs[, task]) (reference: mbmpo.py "
            "validate_config requires env.reward())"
        )
        self.module_spec = ModelCatalog.get_model_spec(
            self.env.observation_space, self.env.action_space, cfg.model_config()
        )
        assert not self.module_spec.discrete, "MBMPO supports continuous control"
        self.obs_dim = self.module_spec.obs_dim
        self.act_dim = self.module_spec.action_dim
        self.learner = cfg.meta_learner(self.module_spec, self.device)
        # Dynamics ensemble: stacked [K, ...] weights, one batched update.
        gen = torch.Generator().manual_seed(cfg.seed + 7)
        self.dyn_params = tree_map(lambda t: t.requires_grad_(True),
                                   dyn_init(gen, cfg.ensemble_size, self.obs_dim, self.act_dim,
                                            cfg.dynamics_hiddens, device=self.device))
        self.dyn_opt = OptaxChain(tree_leaves(self.dyn_params), cfg.dynamics_lr)
        self._replay_obs = np.zeros((0, self.obs_dim), np.float32)
        self._replay_act = np.zeros((0, self.act_dim), np.float32)
        self._replay_next = np.zeros((0, self.obs_dim), np.float32)
        self._start_obs = np.zeros((0, self.obs_dim), np.float32)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 13)
        self._np_rng = np.random.default_rng(cfg.seed)
        self._horizon = int(getattr(self.env, "horizon", 20))
        self._timesteps_total = 0
        self._episode_reward_window: list = []
        n_reward_args = len(inspect.signature(reward_fn).parameters)
        self._task = None
        if n_reward_args >= 4:
            self._task = torch.as_tensor(np.asarray(self.env.get_task(), np.float32), device=self.device)

    def reward(self, obs, act, nxt):
        """The env's ``reward_fn`` on device tensors, with the env's task
        (read at setup) where the function takes one."""
        if self._task is not None:
            return self.env.reward_fn(obs, act, nxt, self._task)
        return self.env.reward_fn(obs, act, nxt)

    # -- the dynamics ensemble ---------------------------------------------
    def ensemble_update(self, obs_k, act_k, nxt_k):
        """One Adam step of every member on its own bootstrap rows (``[K, B,
        ...]`` tensors on the device); returns the members' mean loss (a
        tensor)."""
        with full_f32(self.device):
            losses, grads = ensemble_loss_and_grads(self.dyn_params, obs_k, act_k, nxt_k)
            self.dyn_opt.step(grads)
        return losses.mean()

    def _train_ensemble(self) -> float:
        cfg: MBMPOConfig = self._algo_config
        n = len(self._replay_obs)
        bs = min(cfg.dynamics_batch_size, n)
        loss = float("nan")
        for _ in range(cfg.dynamics_train_epochs):
            # Independent bootstrap draw per model — the ensemble spread
            # (= the MAML task distribution) comes from here.
            idx = self._np_rng.integers(0, n, (cfg.ensemble_size, bs))
            loss = self.ensemble_update(
                *(torch.from_numpy(col[idx]).to(self.device)
                  for col in (self._replay_obs, self._replay_act, self._replay_next)))
        return float(loss)

    def _model_slice(self, k: int):
        return tree_map(lambda x: x[k].detach(), self.dyn_params)

    # -- real and imagined data ---------------------------------------------
    def _noise(self, *shape):
        return torch.randn(shape, generator=self._gen, device=self.device)

    def _collect_real(self, n_episodes: int):
        """Real-env episodes with the current meta-policy; fills the
        transition replay the ensemble trains on."""
        cfg: MBMPOConfig = self._algo_config
        rewards = []
        obs_l, act_l, nxt_l, starts = [], [], [], []
        low = self.env.action_space.low
        high = self.env.action_space.high
        module = self.learner.module
        for _ in range(n_episodes):
            obs, _ = self.env.reset()
            starts.append(np.asarray(obs, np.float32))
            total = 0.0
            while True:
                o = np.asarray(obs, np.float32)
                x = torch.from_numpy(o[None]).to(self.device)
                with torch.no_grad(), full_f32(self.device):
                    a, _, _ = module.sample_actions(x, self._gen, True)
                a_np = np.clip(a.cpu().numpy()[0], low, high).astype(np.float32)
                obs, r, terminated, truncated, _ = self.env.step(a_np)
                total += float(r)
                obs_l.append(o)
                act_l.append(a_np)
                nxt_l.append(np.asarray(obs, np.float32))
                self._timesteps_total += 1
                if terminated or truncated:
                    break
            rewards.append(total)
        self._replay_obs = np.concatenate([self._replay_obs, np.stack(obs_l)])[-cfg.replay_capacity:]
        self._replay_act = np.concatenate([self._replay_act, np.stack(act_l)])[-cfg.replay_capacity:]
        self._replay_next = np.concatenate([self._replay_next, np.stack(nxt_l)])[-cfg.replay_capacity:]
        self._start_obs = np.concatenate([self._start_obs, np.stack(starts)])[-2048:]
        return rewards

    def _imagined_batch(self, policy_params: dict, model, noise=None):
        """One imagined 'task batch' from a single ensemble member, GAE'd
        to the same column layout the MAML update expects. ``noise``: the
        policy draws [H, B, act_dim] (from the algorithm's generator when
        None)."""
        cfg: MBMPOConfig = self._algo_config
        B = cfg.imagined_episodes_per_task
        starts = self._start_obs[self._np_rng.integers(0, len(self._start_obs), B)]
        if noise is None:
            noise = self._noise(self._horizon, B, self.act_dim)
        with full_f32(self.device):
            out = imagine(self.learner.module, policy_params, model, torch.from_numpy(starts).to(self.device),
                          noise, self.reward)
        # [H, B, ...] -> per-episode fragments -> GAE -> concat.
        obs, act, rew, logp, vf = (x.cpu().numpy() for x in out)
        frags = []
        for e in range(B):
            frag = SampleBatch({
                OBS: obs[:, e], ACTIONS: act[:, e], REWARDS: rew[:, e],
                DONES: np.zeros(len(rew), np.float32), LOGPS: logp[:, e],
                VF_PREDS: vf[:, e],
            })
            # Fixed-horizon imagined episodes bootstrap with the policy's
            # own value at the cut — approximated by the final vf pred.
            frags.append(compute_gae(frag, float(vf[-1, e]), cfg.gamma, cfg.lambda_))
        batch = SampleBatch.concat_samples(frags)
        return batch, float(rew.sum(axis=0).mean())

    def training_step(self) -> dict:
        cfg: MBMPOConfig = self._algo_config
        # 1. Real-env data + true return (the reported metric).
        real_rewards = self._collect_real(cfg.real_episodes_per_iter)
        self._episode_reward_window += real_rewards
        self._episode_reward_window = self._episode_reward_window[-100:]
        # 2. Fit the dynamics ensemble.
        model_loss = self._train_ensemble()
        # 3. MAML across the ensemble: model k == task k.
        models = [self._model_slice(k) for k in range(cfg.ensemble_size)]
        theta = {k: p.detach() for k, p in self.learner.params().items()}
        pre, pre_rew = zip(*[self._imagined_batch(theta, m) for m in models])
        pre_stack = stack_batches(list(pre), self.device)
        post, post_rew = [], []
        for m, adapted in zip(models, self.learner.adapted_params(pre_stack)):
            b, r = self._imagined_batch(adapted, m)
            post.append(b)
            post_rew.append(r)
        post_stack = stack_batches(post, self.device)
        loss = None
        for _ in range(cfg.maml_optimizer_steps):
            loss = self.learner.meta_update(pre_stack, post_stack)
        return {
            "meta_loss": float(loss),
            "dynamics_loss": model_loss,
            "real_episode_reward_mean": float(np.mean(real_rewards)),
            "imagined_pre_adaptation_reward": float(np.mean(pre_rew)),
            "imagined_post_adaptation_reward": float(np.mean(post_rew)),
            "adaptation_delta": float(np.mean(post_rew)) - float(np.mean(pre_rew)),
        }

    def step(self) -> dict:
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
        return self.learner.module.get_params()

    def compute_single_action(self, obs, explore: bool = False):
        return self.learner.act(obs, explore)

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict({
            "weights": self.get_policy_weights(),
            "dyn": host_tree(self.dyn_params),
            "timesteps": self._timesteps_total,
            "rng": self._gen.get_state().numpy().copy(),
        })

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        self.learner.module.load_params(data["weights"])
        copy_into(self.dyn_params, data["dyn"])
        self._timesteps_total = data.get("timesteps", 0)
        if "rng" in data:
            self._gen.set_state(torch.from_numpy(np.array(data["rng"], np.uint8)))

    def cleanup(self) -> None:
        env = getattr(self, "env", None)
        if env is not None:
            try:
                env.close()
            except Exception:
                pass
            self.env = None
        eval_ws = getattr(self, "_eval_workers", None)
        if eval_ws is not None:
            eval_ws.stop()
            self._eval_workers = None
