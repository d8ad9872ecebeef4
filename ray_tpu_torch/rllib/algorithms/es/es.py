"""ES — evolution strategies (OpenAI-ES style).

Reference: rllib/algorithms/es/ (es.py, es_tf_policy.py, optimizers.py,
utils.py): black-box optimization — worker actors evaluate antithetic
parameter perturbations for whole episodes; the driver combines
centered-rank-weighted noise into a gradient estimate. The shared-noise-table
trick of the reference becomes shared *seeds*: workers regenerate each
perturbation from its integer seed, so only (seed, return) pairs cross the
object store, never parameter-sized noise.

Placement, as in the JAX package: the worker actors are pinned to the host
(``pin_to_host``, the counterpart of the reference's CPU platform) and run
one forward per env step on the CPU, with one intra-op thread; the driver's
update is numpy float32 on the host, the reference's arithmetic and its
numpy sorts (``argsort`` decides the ranks of tied returns, so no other sort
takes its place). ``compute_single_action`` runs its forward on the config's
device (the card unless it asks for the CPU).

The flat parameter vector lays the RLModule's leaves out in
``jax.tree_util.tree_flatten``'s order (dict keys sorted; each dense ``w`` in
the reference's ``[in, out]`` layout), so one seed's noise perturbs the same
weight in both packages: ``_flatten(rl_module_params_from_jax(p))`` equals the
reference's ``_flatten(p)`` bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig, probe_env
from ray_tpu_torch.rllib.core.learner import full_f32
from ray_tpu_torch.rllib.core.rl_module import RLModule, RLModuleSpec, _device, tree_leaves, tree_unflatten_like


def _flatten(tree):
    """(flat float32 vector, the tree as a template, the leaves' shapes) of a
    params tree (numpy arrays or tensors) or an RLModule."""
    if isinstance(tree, RLModule):
        tree = tree.get_params()
    leaves = [t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in tree_leaves(tree)]
    flat = np.concatenate([leaf.ravel() for leaf in leaves])
    return flat.astype(np.float32), tree, [leaf.shape for leaf in leaves]


def _unflatten(flat, template, shapes):
    """The params tree of ``template``'s structure holding ``flat``."""
    leaves, off = [], 0
    for s in shapes:
        n = int(np.prod(s)) if s else 1
        leaves.append(np.asarray(flat[off : off + n]).reshape(s))
        off += n
    return tree_unflatten_like(template, leaves)


def _centered_ranks(x: np.ndarray) -> np.ndarray:
    """Map returns to centered ranks in [-0.5, 0.5] (reference: utils.py)."""
    ranks = np.empty(len(x), dtype=np.float32)
    ranks[x.argsort()] = np.arange(len(x), dtype=np.float32)
    return ranks / (len(x) - 1) - 0.5


def _noise(seed: int, n: int) -> np.ndarray:
    """The perturbation a seed names (the reference's draw)."""
    return np.random.default_rng(int(seed)).standard_normal(n).astype(np.float32)


class _ESWorker:
    """Evaluates perturbed policies for whole episodes on CPU."""

    def __init__(self, env_spec, spec: RLModuleSpec, env_config, shapes, seed):
        from ray_tpu_torch.rllib.env.vector_env import EnvContext, _make_env
        from ray_tpu_torch.rllib.evaluation.rollout_worker import _in_actor_process

        # One forward per env step of a few rows: one intra-op thread, and an
        # actor's process holds no card.
        torch.set_num_threads(1)
        if _in_actor_process():
            from ray_tpu_torch._private.serialization import pin_to_host

            pin_to_host()
        self.env = _make_env(env_spec, EnvContext(env_config or {}, 0, 0))
        self.spec = spec
        self.shapes = shapes
        self._module = RLModule(spec, device="cpu").requires_grad_(False)
        self.template = self._module.get_params()
        self._np_rng = np.random.default_rng(seed)

    @torch.no_grad()
    def _act(self, o: np.ndarray):
        out = self._module(torch.from_numpy(np.require(o, np.float32, "W").reshape(1, -1)))[0][0].numpy()
        return int(out.argmax()) if self.spec.discrete else np.tanh(out)

    def _episode_return(self, flat, episode_horizon: int) -> tuple:
        self._module.load_params(_unflatten(flat, self.template, self.shapes))
        obs, _ = self.env.reset(seed=int(self._np_rng.integers(1 << 31)))
        total, steps = 0.0, 0
        while steps < episode_horizon:
            obs, r, terminated, truncated, _ = self.env.step(self._act(obs))
            total += float(r)
            steps += 1
            if terminated or truncated:
                break
        return total, steps

    def rollout(self, flat_params: np.ndarray, seeds: list, sigma: float, episode_horizon: int):
        """Antithetic evaluation: for each seed return (R+, R-, env steps)."""
        out = []
        for s in seeds:
            noise = _noise(s, len(flat_params))
            r_pos, n_pos = self._episode_return(flat_params + sigma * noise, episode_horizon)
            r_neg, n_neg = self._episode_return(flat_params - sigma * noise, episode_horizon)
            out.append((r_pos, r_neg, n_pos + n_neg))
        return out

    def evaluate(self, flat_params: np.ndarray, episodes: int, episode_horizon: int) -> list:
        """Returns (reward, env steps) per episode."""
        return [self._episode_return(flat_params, episode_horizon) for _ in range(episodes)]

    def stop(self):
        self.env.close()
        return True


class ESConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ES)
        self.num_rollout_workers = 4
        self.episodes_per_batch = 40  # perturbation pairs per iteration
        self.noise_stdev = 0.02
        self.stepsize = 0.01
        self.l2_coeff = 0.005
        self.episode_horizon = 1000
        self.eval_episodes = 5

    def training(self, *, episodes_per_batch=None, noise_stdev=None, stepsize=None,
                 l2_coeff=None, episode_horizon=None, eval_episodes=None, **kwargs) -> "ESConfig":
        super().training(**kwargs)
        for name, val in (
            ("episodes_per_batch", episodes_per_batch),
            ("noise_stdev", noise_stdev),
            ("stepsize", stepsize),
            ("l2_coeff", l2_coeff),
            ("episode_horizon", episode_horizon),
            ("eval_episodes", eval_episodes),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class ES(Algorithm):
    # Subclasses (ARS) substitute their own worker actor class.
    _worker_cls = _ESWorker

    @classmethod
    def get_default_config(cls) -> ESConfig:
        return ESConfig(cls)

    def setup(self, config: dict) -> None:
        # Re-setup must not orphan the previous worker gang (same guard as
        # base Algorithm.setup — leaked actors hold CPU reservations).
        self.cleanup()
        cfg: ESConfig = self._algo_config
        self.device = _device(cfg.device)  # no card and no device="cpu": raise before any worker starts
        from ray_tpu_torch.rllib.models import ModelCatalog

        with probe_env(cfg) as probe:
            self.module_spec = ModelCatalog.get_model_spec(
                probe.observation_space, probe.action_space, cfg.model_config()
            )
        self.flat, self._template, self._shapes = _flatten(RLModule(self.module_spec, cfg.seed, device="cpu"))
        self._act_module = RLModule(self.module_spec, device=self.device).requires_grad_(False)
        # Adam state for the ES gradient estimate (reference: optimizers.py).
        self._m = np.zeros_like(self.flat)
        self._v = np.zeros_like(self.flat)
        self._t = 0
        self._np_rng = np.random.default_rng(cfg.seed)
        make = ray_tpu_torch.remote(num_cpus=1)(self._worker_cls).remote
        self._workers = [
            make(cfg.env, self.module_spec, cfg.env_config, self._shapes, cfg.seed + i)
            for i in range(max(cfg.num_rollout_workers, 1))
        ]
        self._timesteps_total = 0
        self._episode_reward_window: list = []

    def _antithetic_rollouts(self, n: int) -> tuple:
        """``n`` seeds drawn and split over the workers; their antithetic
        returns. Returns (pairs, the seeds that came back, env steps); a lost
        worker's share is dropped."""
        cfg: ESConfig = self._algo_config
        seeds = self._np_rng.integers(0, 1 << 31, n)
        per_worker = np.array_split(seeds, len(self._workers))
        refs = [
            w.rollout.remote(self.flat, list(map(int, chunk)), cfg.noise_stdev, cfg.episode_horizon)
            for w, chunk in zip(self._workers, per_worker)
            if len(chunk)
        ]
        pairs: list = []
        used_seeds: list = []
        steps = 0
        for ref, chunk in zip(refs, [c for c in per_worker if len(c)]):
            try:
                res = ray_tpu_torch.get(ref, timeout=600)
            except Exception:
                continue  # lost worker: proceed with the survivors' episodes
            pairs += [(rp, rn) for rp, rn, _ in res]
            steps += sum(n for _, _, n in res)
            used_seeds += list(chunk)
        return pairs, used_seeds, steps

    def _evaluate_flat(self) -> tuple:
        """The unperturbed policy's episodes on the first worker: (rewards,
        env steps)."""
        cfg: ESConfig = self._algo_config
        try:
            evals = ray_tpu_torch.get(
                self._workers[0].evaluate.remote(self.flat, cfg.eval_episodes, cfg.episode_horizon), timeout=600)
        except Exception:
            evals = []
        return [r for r, _ in evals], sum(n for _, n in evals)

    def es_update(self, returns: np.ndarray, seeds: list) -> np.ndarray:
        """One ES step of ``self.flat`` from the antithetic returns ([n, 2] =
        (R+, R-)) of ``seeds``' perturbations; returns the gradient estimate."""
        cfg: ESConfig = self._algo_config
        # Centered-rank transform over ALL evaluations, antithetic pairing.
        ranks = _centered_ranks(returns.ravel()).reshape(returns.shape)
        weights = ranks[:, 0] - ranks[:, 1]
        grad = np.zeros_like(self.flat)
        for w, s in zip(weights, seeds):
            grad += w * _noise(s, len(self.flat))
        grad /= len(weights) * cfg.noise_stdev
        grad -= cfg.l2_coeff * self.flat  # weight decay
        # Adam ascent.
        self._t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        self._m = b1 * self._m + (1 - b1) * grad
        self._v = b2 * self._v + (1 - b2) * grad * grad
        mhat = self._m / (1 - b1**self._t)
        vhat = self._v / (1 - b2**self._t)
        self.flat = self.flat + cfg.stepsize * mhat / (np.sqrt(vhat) + eps)
        return grad

    def _report(self, rewards: list, steps: int) -> None:
        # Real env-step counts from the workers (an estimate here would leak
        # into stop criteria like stop_timesteps).
        self._timesteps_total += steps
        self._episode_reward_window += rewards
        self._episode_reward_window = self._episode_reward_window[-100:]

    def training_step(self) -> dict:
        pairs, used_seeds, steps = self._antithetic_rollouts(self._algo_config.episodes_per_batch)
        if not pairs:
            return {"es_update_skipped": 1.0}
        returns = np.asarray(pairs, np.float32)  # [n, 2] = (R+, R-)
        grad = self.es_update(returns, used_seeds)
        rewards, eval_steps = self._evaluate_flat()
        self._report(rewards, steps + eval_steps)
        return {
            "episode_reward_mean": float(np.mean(rewards)) if rewards else float("nan"),
            "grad_norm": float(np.linalg.norm(grad)),
            "perturbations_this_iter": float(len(pairs) * 2),
        }

    def step(self) -> dict:
        t0 = time.time()
        result = self.training_step()
        result.setdefault(
            "episode_reward_mean",
            float(np.mean(self._episode_reward_window)) if self._episode_reward_window else float("nan"),
        )
        result["timesteps_total"] = self._timesteps_total
        result["time_this_iter_s"] = time.time() - t0
        return result

    @torch.no_grad()
    def compute_single_action(self, obs, explore: bool = False):
        module = self._act_module.load_params(_unflatten(self.flat, self._template, self._shapes))
        x = torch.from_numpy(np.require(obs, np.float32, "W").reshape(1, -1)).to(self.device)
        with full_f32(self.device):
            out = module(x)[0][0].cpu().numpy()
        return int(out.argmax()) if self.module_spec.discrete else np.tanh(out)

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        # Adam moments and the seed stream are training state: without them a
        # pause/resume (routine under sync HyperBand) spikes the step size
        # (fresh bias correction) and replays the same noise directions.
        return Checkpoint.from_dict({
            "flat": self.flat,
            "timesteps": self._timesteps_total,
            "adam_m": np.asarray(self._m),
            "adam_v": np.asarray(self._v),
            "adam_t": self._t,
            "np_rng_state": self._np_rng.bit_generator.state,
        })

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        self.flat = np.asarray(data["flat"], np.float32)
        self._timesteps_total = data.get("timesteps", 0)
        if "adam_m" in data:
            self._m = np.asarray(data["adam_m"], np.float32)
            self._v = np.asarray(data["adam_v"], np.float32)
            self._t = int(data["adam_t"])
        if data.get("np_rng_state") is not None:
            self._np_rng = np.random.default_rng()
            self._np_rng.bit_generator.state = data["np_rng_state"]

    def cleanup(self) -> None:
        for w in getattr(self, "_workers", []):
            ray_tpu_torch.kill(w)
        self._workers = []
