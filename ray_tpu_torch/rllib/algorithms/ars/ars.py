"""ARS — Augmented Random Search (Mania et al. 2018).

Reference: rllib/algorithms/ars/ (ars.py, ars_tf_policy.py): like ES, a
black-box method evaluating antithetic parameter perturbations in worker
actors — but with ARS's three augmentations over vanilla random search:

1. TOP-K direction selection: only the ``num_top_directions`` best
   directions (ranked by max(R+, R-)) enter the update;
2. raw-return weighting scaled by the STD of the used returns (no rank
   transform, no Adam — plain scaled SGD ascent);
3. a running observation mean/std filter (ARS-V2, the reference's
   MeanStdFilter): workers normalize observations and ship their
   accumulated statistics back for merging each iteration.

Shares the ES worker/seed machinery and its placement (es.py): workers
pinned to the host, one CPU forward per env step, the update numpy float32
on the host (its top-k is the reference's ``np.argsort``, ties and all), and
``compute_single_action`` on the config's device.
"""

from __future__ import annotations

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.es.es import ES, ESConfig, _ESWorker, _noise, _unflatten


class _ARSWorker(_ESWorker):
    """ES worker + observation normalization with stat accumulation."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._obs_mean = None
        self._obs_std = None
        self._acc_count = 0
        self._acc_sum = None
        self._acc_sumsq = None

    def set_obs_stats(self, mean, std):
        self._obs_mean = np.asarray(mean, np.float32) if mean is not None else None
        self._obs_std = np.asarray(std, np.float32) if std is not None else None
        return True

    def _episode_return(self, flat, episode_horizon: int):
        self._module.load_params(_unflatten(flat, self.template, self.shapes))
        obs, _ = self.env.reset(seed=int(self._np_rng.integers(1 << 31)))
        total, steps = 0.0, 0
        while steps < episode_horizon:
            o = np.asarray(obs, np.float32).reshape(-1)
            # Accumulate BEFORE normalizing (the filter models raw obs).
            if self._acc_sum is None:
                self._acc_sum = np.zeros_like(o)
                self._acc_sumsq = np.zeros_like(o)
            self._acc_count += 1
            self._acc_sum += o
            self._acc_sumsq += o * o
            if self._obs_mean is not None:
                o = (o - self._obs_mean) / (self._obs_std + 1e-8)
            obs, r, terminated, truncated, _ = self.env.step(self._act(o))
            total += float(r)
            steps += 1
            if terminated or truncated:
                break
        return total, steps

    def drain_obs_stats(self):
        """(count, sum, sumsq) accumulated since the last drain."""
        out = (
            self._acc_count,
            None if self._acc_sum is None else self._acc_sum.copy(),
            None if self._acc_sumsq is None else self._acc_sumsq.copy(),
        )
        self._acc_count = 0
        if self._acc_sum is not None:
            self._acc_sum[:] = 0
            self._acc_sumsq[:] = 0
        return out


class ARSConfig(ESConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ARS)
        self.episodes_per_batch = 32       # directions per iteration
        self.num_top_directions = 16       # top-k by max(R+, R-)
        self.noise_stdev = 0.025
        self.stepsize = 0.02               # SGD ascent rate (no Adam)
        self.observation_filter = True     # ARS-V2 MeanStdFilter

    def training(self, *, num_top_directions=None, observation_filter=None, **kwargs) -> "ARSConfig":
        super().training(**kwargs)
        if num_top_directions is not None:
            self.num_top_directions = num_top_directions
        if observation_filter is not None:
            self.observation_filter = observation_filter
        return self


class ARS(ES, Algorithm):
    _worker_cls = _ARSWorker

    @classmethod
    def get_default_config(cls) -> ARSConfig:
        return ARSConfig(cls)

    def setup(self, config: dict) -> None:
        super().setup(config)
        # Running obs filter state (merged across workers each iteration).
        self._obs_count = 0
        self._obs_sum = None
        self._obs_sumsq = None

    def merge_obs_stats(self, drained: list) -> None:
        """Fold the workers' drained (count, sum, sumsq) into the running
        filter, and hand every worker the merged mean and std."""
        for count, s, sq in drained:
            if count and s is not None:
                if self._obs_sum is None:
                    self._obs_sum = np.zeros_like(s)
                    self._obs_sumsq = np.zeros_like(sq)
                self._obs_count += count
                self._obs_sum += s
                self._obs_sumsq += sq
        if self._obs_count > 1:
            mean = self._obs_sum / self._obs_count
            var = np.maximum(self._obs_sumsq / self._obs_count - mean * mean, 1e-8)
            std = np.sqrt(var)
            self._obs_mean_cur, self._obs_std_cur = mean, std
            for w in self._workers:
                w.set_obs_stats.remote(mean, std)

    def _merge_obs_stats(self):
        # Fan out the drains, then collect: N sequential round trips would
        # serialize the iteration on worker latency.
        refs = [w.drain_obs_stats.remote() for w in self._workers]
        drained = []
        for ref in refs:
            try:
                drained.append(ray_tpu_torch.get(ref, timeout=120))
            except Exception:
                continue  # a lost worker's statistics are dropped
        self.merge_obs_stats(drained)

    def ars_update(self, returns: np.ndarray, seeds: list) -> tuple:
        """One ARS step of ``self.flat`` from the antithetic returns ([n, 2] =
        (R+, R-)) of ``seeds``' directions: (k, sigma_r)."""
        cfg = self._algo_config
        # Augmentation 1: keep only the top-k directions by max(R+, R-).
        k = min(cfg.num_top_directions, len(returns))
        order = np.argsort(-returns.max(axis=1))[:k]
        top = returns[order]
        top_seeds = [seeds[i] for i in order]
        # Augmentation 2: raw-return weights scaled by the std of USED returns.
        sigma_r = float(top.std()) or 1.0
        grad = np.zeros_like(self.flat)
        for (r_pos, r_neg), s in zip(top, top_seeds):
            grad += (r_pos - r_neg) * _noise(s, len(self.flat))
        grad /= k * sigma_r
        grad -= cfg.l2_coeff * self.flat  # weight decay (inherited ES knob)
        self.flat = self.flat + cfg.stepsize * grad
        return k, sigma_r

    def training_step(self) -> dict:
        cfg = self._algo_config
        pairs, used_seeds, steps = self._antithetic_rollouts(cfg.episodes_per_batch)
        if cfg.observation_filter:
            self._merge_obs_stats()
        if not pairs:
            return {"ars_update_skipped": 1.0}
        k, sigma_r = self.ars_update(np.asarray(pairs, np.float32), used_seeds)
        rewards, eval_steps = self._evaluate_flat()
        self._report(rewards, steps + eval_steps)
        return {
            "episode_reward_mean": float(np.mean(rewards)) if rewards else float("nan"),
            "top_directions_used": float(k),
            "return_std": sigma_r,
        }

    def compute_single_action(self, obs, explore: bool = False):
        mean = getattr(self, "_obs_mean_cur", None)
        if mean is not None:
            obs = (np.asarray(obs, np.float32).reshape(-1) - mean) / (
                self._obs_std_cur + 1e-8
            )
        return super().compute_single_action(obs, explore=explore)

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        ckpt = super().save_checkpoint().to_dict()
        # The observation filter is part of the POLICY: weights are fit to
        # normalized observations, so restoring them without the filter
        # stats feeds raw obs to a normalized-obs policy.
        ckpt["obs_filter"] = {
            "count": self._obs_count,
            "sum": None if self._obs_sum is None else np.asarray(self._obs_sum),
            "sumsq": None if self._obs_sumsq is None else np.asarray(self._obs_sumsq),
            "mean": getattr(self, "_obs_mean_cur", None),
            "std": getattr(self, "_obs_std_cur", None),
        }
        return Checkpoint.from_dict(ckpt)

    def load_checkpoint(self, checkpoint) -> None:
        super().load_checkpoint(checkpoint)
        flt = checkpoint.to_dict().get("obs_filter")
        if flt:
            self._obs_count = flt.get("count", 0)
            self._obs_sum = flt.get("sum")
            self._obs_sumsq = flt.get("sumsq")
            if flt.get("mean") is not None:
                self._obs_mean_cur = np.asarray(flt["mean"], np.float32)
                self._obs_std_cur = np.asarray(flt["std"], np.float32)
                for w in self._workers:
                    w.set_obs_stats.remote(self._obs_mean_cur, self._obs_std_cur)
