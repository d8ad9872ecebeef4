"""Shared plumbing for the replay-based and offline algorithms (SAC,
DDPG/TD3, Ape-X DDPG, CQL, CRR, MADDPG).

These all hold a ``self.params`` tree of tensors on the config's device and a
target tree (``self.target``, or the attribute ``_target_attr`` names), their
optimizer chains (``self.opt``: one :class:`OptaxChain`, or a dict of them), a
timestep counter and, where they draw on the device, a ``torch.Generator``
(``self._gen``). Step timing, the 100-episode reward window and
checkpointing live in :class:`OffPolicyTraining`; the MLPs in the JAX
package's layout, the env probe and the replay transition live here too.

The checkpoint holds the weights, the targets, the optimizer state
(``OptaxChain.state_dict()``: numpy moments), the generator's state, the numpy
bit-generator's state, the timesteps and TD3's delay phase (``_updates``);
``load_checkpoint`` restores all of them onto the algorithm's device.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ray_tpu_torch.rllib.core.rl_module import _device, _is_discrete, copy_into, host_tree, tree_map


# -- the MLPs (the JAX package's layout) ---------------------------------------------------


def dense_params(gen, din, dout):
    """Glorot-uniform ``w`` (``jax.nn.initializers.glorot_uniform``'s
    bounds), zero ``b``."""
    limit = math.sqrt(6.0 / (din + dout))
    w = (torch.rand(din, dout, generator=gen) * 2.0 - 1.0) * limit
    return {"w": w, "b": torch.zeros(dout)}


def mlp_params(gen, din, hiddens, dout):
    """A list of dense ``{"w": [din, dout], "b": [dout]}`` layers drawn from
    the torch generator ``gen``."""
    layers = []
    for h in hiddens:
        layers.append(dense_params(gen, din, h))
        din = h
    layers.append(dense_params(gen, din, dout))
    return layers


def mlp_apply(layers, x):
    """ReLU between the layers, ``x @ w + b`` each."""
    for layer in layers[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x @ layers[-1]["w"] + layers[-1]["b"]


def mlp_params_from_jax(layers, *, device="cuda") -> list:
    """The JAX package's MLP (a list of ``{"w": [din, dout], "b": [dout]}``
    with numpy leaves, as ``jax.tree_util.tree_map(np.asarray, ...)`` gives
    them) as the port's list of f32 tensors on ``device``: the layouts
    agree, the leaves copy as they are. Stacked layers (a leading agent
    axis, MADDPG) copy the same way."""
    dev = _device(device)
    return [{k: torch.tensor(np.asarray(layer[k]), dtype=torch.float32, device=dev) for k in ("w", "b")}
            for layer in layers]


def frozen(tree):
    """``jax.lax.stop_gradient`` of a params tree."""
    return tree_map(lambda t: t.detach(), tree)


def trainable(tree, device):
    """A tree of tensors moved to ``device`` as leaves that take gradients."""
    return tree_map(lambda t: t.to(device).requires_grad_(True), tree)


@torch.no_grad()
def polyak(targets: list, params: list, tau: float) -> None:
    """``t <- (1 - tau) t + tau p`` over two leaf lists, in place."""
    torch._foreach_mul_(targets, 1 - tau)
    torch._foreach_add_(targets, torch._foreach_mul([p.detach() for p in params], tau))


# -- env plumbing --------------------------------------------------------------------------


def env_spaces(cfg):
    """(discrete, obs_dim, action_dim, act_scale, act_offset) of ``cfg.env``,
    read from the algorithm's probe env."""
    from ray_tpu_torch.rllib.algorithms.algorithm import probe_env

    with probe_env(cfg) as probe:
        discrete = _is_discrete(probe.action_space)
        obs_dim = int(np.prod(probe.observation_space.shape))
        if discrete:
            return True, obs_dim, int(probe.action_space.n), None, None
        low = np.asarray(probe.action_space.low, np.float32)
        high = np.asarray(probe.action_space.high, np.float32)
        return False, obs_dim, int(np.prod(probe.action_space.shape)), (high - low) / 2.0, (high + low) / 2.0


def true_transition(env, dones, infos):
    """(next_obs, terminated-mask) for replay: at episode boundaries the true
    s' is the PRE-reset observation, and only real terminations (not
    time-limit truncations) zero the TD bootstrap."""
    next_obs = env.current_obs().astype(np.float32).reshape(env.num_envs, -1)
    terminateds = np.zeros(env.num_envs, np.float32)
    for i, (d, info) in enumerate(zip(dones, infos)):
        if d:
            next_obs[i] = np.asarray(info["final_observation"], np.float32).reshape(-1)
            terminateds[i] = float(info.get("terminated", True))
    return next_obs, terminateds


# -- training loop and checkpoints -----------------------------------------------------------


class OffPolicyTraining:
    _target_attr = "target"  # the attribute holding the target tree

    def step(self) -> dict:
        t0 = time.time()
        result = self.training_step()
        window = getattr(self, "_episode_reward_window", [])
        result["episode_reward_mean"] = (
            float(np.mean(window)) if window else float("nan")
        )
        result["timesteps_total"] = self._timesteps_total
        result["time_this_iter_s"] = time.time() - t0
        return result

    def _opt_state(self):
        if isinstance(self.opt, dict):
            return {k: v.state_dict() for k, v in self.opt.items()}
        return self.opt.state_dict()

    def _load_opt_state(self, state) -> None:
        if isinstance(self.opt, dict):
            for k, v in self.opt.items():
                v.load_state_dict(state[k])
        else:
            self.opt.load_state_dict(state)

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        # Optimizer state, RNGs, and the policy-delay counter are part of the
        # training state: dropping them silently resets Adam moments and
        # DDPG/TD3's delayed-actor phase on restore (reference policy state
        # includes optimizer variables).
        state = {
            "params": host_tree(self.params),
            "target": host_tree(getattr(self, self._target_attr)),
            "opt_state": self._opt_state(),
            # Snapshot the bit-generator state dict, not the live Generator:
            # the object would keep mutating after save (and aliasing it on
            # load would share one stream between algorithms).
            # Offline algos (CQL, CRR) have no exploration rng.
            "np_rng_state": (
                self._np_rng.bit_generator.state if hasattr(self, "_np_rng") else None
            ),
            "timesteps": self._timesteps_total,
        }
        if hasattr(self, "_gen"):  # MADDPG draws nothing on the device
            state["rng"] = self._gen.get_state().numpy().copy()
        if hasattr(self, "_updates"):
            state["updates"] = self._updates
        return Checkpoint.from_dict(state)

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        copy_into(self.params, data["params"])
        copy_into(getattr(self, self._target_attr), data["target"])
        if "opt_state" in data:
            self._load_opt_state(data["opt_state"])
        if "rng" in data:
            self._gen.set_state(torch.from_numpy(np.array(data["rng"], np.uint8)))
        if data.get("np_rng_state") is not None:
            self._np_rng = np.random.default_rng()
            self._np_rng.bit_generator.state = data["np_rng_state"]
        if "updates" in data:
            self._updates = data["updates"]
        self._timesteps_total = data.get("timesteps", 0)

    def cleanup(self) -> None:
        env = getattr(self, "env", None)
        if env is not None:
            env.close()


def floats(metric_tree) -> dict:
    """Convert an update's metric tensors to host floats in one transfer —
    call ONCE per iteration after the update loop, not per gradient step
    (each conversion blocks on the device and would defeat async dispatch in
    the hot loop)."""
    metric_tree = dict(metric_tree)
    if not metric_tree:
        return {}
    vals = torch.stack([v.detach().float().reshape(()) for v in metric_tree.values()])
    return dict(zip(metric_tree, vals.cpu().tolist()))
