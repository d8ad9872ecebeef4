"""Legacy Policy facade over the new-stack RLModule.

The reference ships a full legacy policy layer (`rllib/policy/policy.py:175`
`class Policy`, `compute_single_action:466`, `compute_actions:630`,
`compute_log_likelihoods:674`, `postprocess_trajectory:710`,
`get_weights:906` / `set_weights:921`, `get_state:971` / `set_state:1046`,
`export_checkpoint:1128`, `from_checkpoint:265`) that external-serving
paths (PolicyClient/Server), offline evaluation, and user code built
against. This build is new-stack-first — the numerics live in
`core/rl_module.py`'s RLModule — so `Policy` here is a thin stateful VIEW
over (spec, params): the classic API surface, with every forward delegating
to the same module the rollout workers and learners use. No second model
implementation exists to drift. ``params`` is the params tree of numpy
arrays (the JAX package's keys and layout) that ``Algorithm.get_policy``
and the learners' ``get_weights`` give; the forward runs on ``device``, the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.core.rl_module import RLModule, tree_map
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch, compute_gae


class Policy:
    """Stateful view over an RLModuleSpec + params pytree.

    Construct directly, via :meth:`from_spaces`, or snapshot a trained
    algorithm with ``algo.get_policy()`` (weights are copied at call time —
    call again after more training for fresh ones).

    ``obs_filter_state`` carries the training-time observation filter
    (MeanStdFilter running statistics): a policy trained behind a filter
    must see filtered observations at inference too, so every
    ``compute_*`` call applies it before the forward.
    """

    def __init__(self, spec, params, observation_space=None, action_space=None, config: Optional[dict] = None,
                 obs_filter_state: Optional[dict] = None, *, device="cuda"):
        self.spec = spec
        self.observation_space = observation_space
        self.action_space = action_space
        self.config = dict(config or {})
        self._obs_filter_state = obs_filter_state
        self._module = RLModule(spec, device=device).requires_grad_(False)
        self.set_weights(params)
        self._gen = torch.Generator(device=self._module.device).manual_seed(int(self.config.get("seed", 0)))

    def _filter_obs(self, obs: np.ndarray) -> np.ndarray:
        if self._obs_filter_state is None:
            return obs
        from ray_tpu_torch.rllib.connectors import MeanStdFilter

        f = MeanStdFilter()
        f.set_state(self._obs_filter_state)
        return np.asarray(f.transform(obs), np.float32)

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_spaces(cls, observation_space, action_space, config: Optional[dict] = None, *,
                    device="cuda") -> "Policy":
        from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

        cfg = dict(config or {})
        spec = RLModuleSpec.from_spaces(
            observation_space, action_space, hiddens=tuple(cfg.get("hiddens", (64, 64)))
        )
        params = RLModule(spec, int(cfg.get("seed", 0)), device="cpu").get_params()
        return cls(spec, params, observation_space, action_space, cfg, device=device)

    @classmethod
    def from_checkpoint(cls, path: str, *, device="cuda") -> "Policy":
        """Reference: Policy.from_checkpoint (rllib/policy/policy.py:265)."""
        with open(os.path.join(path, "policy_state.pkl"), "rb") as f:
            state = pickle.load(f)
        return cls(
            state["spec"],
            state["weights"],
            config=state.get("config"),
            obs_filter_state=state.get("obs_filter"),
            device=device,
        )

    # -- inference ---------------------------------------------------------

    def compute_actions(
        self, obs_batch, explore: bool = True, **kwargs
    ) -> Tuple[np.ndarray, List, Dict[str, np.ndarray]]:
        """Batch inference → (actions, state_outs, extra_fetches).

        Reference signature/semantics: rllib/policy/policy.py:630 — extra
        fetches carry per-sample ``action_logp`` and ``vf_preds``.
        """
        obs = self._obs_tensor(obs_batch)
        actions, logp, value = self._module.sample_actions(obs, self._gen, explore)
        return (
            actions.cpu().numpy(),
            [],
            {"action_logp": logp.cpu().numpy(), "vf_preds": value.cpu().numpy()},
        )

    def compute_single_action(self, obs, explore: bool = True, **kwargs):
        """Reference: rllib/policy/policy.py:466. Returns
        (action, state_outs, info)."""
        actions, state, info = self.compute_actions(
            np.asarray(obs, np.float32)[None], explore=explore
        )
        a = actions[0]
        info = {k: v[0] for k, v in info.items()}
        return (a.item() if self.spec.discrete else a), state, info

    def compute_log_likelihoods(self, actions, obs_batch) -> np.ndarray:
        """Reference: rllib/policy/policy.py:674 — log p(a|s) under the
        current params for externally chosen actions."""
        obs = self._obs_tensor(obs_batch)
        acts = torch.as_tensor(np.asarray(actions)).to(self._module.device)
        logp, _, _ = self._module.action_logp_and_entropy(obs, acts)
        return logp.cpu().numpy()

    # -- trajectory postprocessing ----------------------------------------

    def postprocess_trajectory(
        self, sample_batch: SampleBatch, last_value: float = 0.0
    ) -> SampleBatch:
        """GAE advantages/value targets in place of the reference's
        per-policy postprocess_fn (rllib/policy/policy.py:710); requires
        ``vf_preds`` (filled by compute_actions) and rewards/dones.
        ``last_value`` bootstraps a mid-episode fragment cut."""
        return compute_gae(
            sample_batch,
            last_value,
            gamma=float(self.config.get("gamma", 0.99)),
            lambda_=float(self.config.get("lambda", 0.95)),
        )

    # -- weights / state ---------------------------------------------------

    def _obs_tensor(self, obs_batch) -> torch.Tensor:
        obs = self._filter_obs(np.asarray(obs_batch, np.float32))
        return torch.from_numpy(np.ascontiguousarray(obs, np.float32)).to(self._module.device)

    @property
    def params(self) -> dict:
        return self._params

    def get_weights(self):
        return self._params

    def set_weights(self, weights) -> None:
        self._params = tree_map(lambda x: np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x), weights)
        self._module.load_params(self._params)

    def get_state(self) -> Dict[str, Any]:
        return {
            "weights": self.params,
            "spec": self.spec,
            "config": self.config,
            "obs_filter": self._obs_filter_state,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        if state.get("spec", self.spec) != self.spec:
            self.spec = state["spec"]
            self._module = RLModule(self.spec, device=self._module.device).requires_grad_(False)
        self.set_weights(state["weights"])
        self.config = dict(state.get("config", self.config))
        self._obs_filter_state = state.get("obs_filter", self._obs_filter_state)

    def export_checkpoint(self, export_dir: str) -> None:
        """Reference: rllib/policy/policy.py:1128."""
        os.makedirs(export_dir, exist_ok=True)
        with open(os.path.join(export_dir, "policy_state.pkl"), "wb") as f:
            pickle.dump(self.get_state(), f)
