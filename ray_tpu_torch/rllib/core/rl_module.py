"""RLModule — the neural policy/value model, a ``torch.nn.Module``.

Reference: rllib/core/rl_module/rl_module.py (new-stack RLModule with
forward_exploration / forward_train). The JAX package's module is a params
pytree with pure functions over it (``init_params``, ``forward``,
``sample_actions``, ``action_logp_and_entropy``); here the same functions are
methods of one module. Discrete policies use categorical logits, continuous
ones a diagonal gaussian. The same module serves rollout workers (a CPU
forward) and learners (the update on the card); only the weights move.

The module keeps its weights in the JAX package's layout, so the two trade
weights without a permutation: a dense layer's ``w`` is ``[din, dout]`` and
is applied as ``x @ w``; a conv's ``w`` is HWIO. The conv torso takes NHWC
observations, runs NCHW convolutions (``F.conv2d`` over the weight permuted to
OIHW, VALID padding) and permutes back to NHWC before the flatten, so the
first dense layer sees its features in the reference's order.
``get_params`` / ``load_params`` trade a nested dict of numpy arrays with the
reference's keys (``pi``, ``vf``, ``pi_conv``, ``vf_conv`` as lists of
``{"w", "b"}``; ``pi_out``, ``vf_out``; ``log_std``), and
``rl_module_params_from_jax`` builds a module from the JAX package's params.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _device(device) -> torch.device:
    """``device`` as a ``torch.device``; a card without an index is the
    current card (``cuda:<i>``). Raises when asked for a card and there is
    none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _is_discrete(space) -> bool:
    # gymnasium's Discrete and the port's own (env/spaces.py) carry ``n``; a
    # Box carries ``low``.
    return getattr(space, "n", None) is not None and not hasattr(space, "low")


@dataclasses.dataclass(frozen=True)
class RLModuleSpec:
    obs_dim: int
    action_dim: int
    discrete: bool
    hiddens: Tuple[int, ...] = (64, 64)
    activation: str = "tanh"
    free_log_std: bool = True  # continuous: state-independent log_std
    # Image observations: HWC shape + conv torso spec [(out_ch, kernel,
    # stride), ...] (reference: ModelCatalog VisionNet filters,
    # rllib/models/catalog.py). Empty = flat MLP.
    obs_shape: Tuple[int, ...] = ()
    conv_filters: Tuple[Tuple[int, int, int], ...] = ()

    @staticmethod
    def from_spaces(observation_space, action_space, hiddens=(64, 64),
                    conv_filters=None) -> "RLModuleSpec":
        """From a Box observation space and a Discrete or Box action space:
        the port's (env/spaces.py) or gymnasium's."""
        obs_dim = int(np.prod(observation_space.shape))
        shape = tuple(observation_space.shape)
        convs: Tuple = ()
        if len(shape) == 3:
            convs = tuple(conv_filters) if conv_filters else default_conv_filters(shape)
        elif conv_filters:
            raise ValueError("conv_filters requires a 3D (H, W, C) observation space")
        if _is_discrete(action_space):
            return RLModuleSpec(obs_dim, int(action_space.n), True, tuple(hiddens),
                                obs_shape=shape if convs else (), conv_filters=convs)
        return RLModuleSpec(obs_dim, int(np.prod(action_space.shape)), False, tuple(hiddens),
                            obs_shape=shape if convs else (), conv_filters=convs)


def default_conv_filters(shape: Tuple[int, ...]) -> Tuple[Tuple[int, int, int], ...]:
    """Default conv stacks by input size (reference: catalog.py
    _get_filter_config — 84x84 Atari stack, smaller stacks otherwise).
    Tiny spatial dims get NO convs (flat MLP) rather than a stack that
    collapses to zero — a (4,4,1) gridworld must keep training."""
    h = min(shape[0], shape[1])
    if h >= 84:
        return ((16, 8, 4), (32, 4, 2), (64, 3, 1))
    if h >= 42:
        return ((16, 4, 2), (32, 4, 2), (64, 3, 1))
    if h >= 7:
        return ((16, 3, 2), (32, 3, 2))
    if h >= 3:
        return ((16, 3, 1),)
    return ()


_ACTS = {"tanh": torch.tanh, "relu": F.relu, "swish": F.silu}


def _conv_out_dim(spec: RLModuleSpec) -> int:
    h, w, c = spec.obs_shape
    for out_ch, k, s in spec.conv_filters:
        h = (h - k) // s + 1
        w = (w - k) // s + 1
        c = out_ch
    if h <= 0 or w <= 0:
        raise ValueError(f"conv_filters {spec.conv_filters} collapse a {spec.obs_shape} input")
    return h * w * c


def _orthogonal(shape, scale, gen) -> torch.Tensor:
    """jax.nn.initializers.orthogonal's layout: an orthogonal matrix of
    ``prod(shape[:-1])`` rows and ``shape[-1]`` columns, reshaped."""
    m = torch.empty(int(np.prod(shape[:-1])), shape[-1])
    nn.init.orthogonal_(m, gain=scale, generator=gen)
    return m.reshape(shape)


class _Layer(nn.Module):
    """One dense (``w`` [din, dout]) or conv (``w`` HWIO) layer and its bias."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class RLModule(nn.Module):
    """Orthogonal-init torso (conv stack for image obs, reference VisionNet;
    MLP otherwise, reference FCNet) + policy and value heads.

    The weights are drawn on the CPU from ``seed`` (so a module on the card
    and one on the CPU start equal) and then moved to ``device``."""

    def __init__(self, spec: RLModuleSpec, seed: int = 0, *, device="cuda"):
        super().__init__()
        dev = _device(device)
        self.spec = spec
        gen = torch.Generator().manual_seed(seed)

        def dense(din, dout, scale):
            return _Layer(_orthogonal((din, dout), scale, gen), torch.zeros(dout))

        n_conv = len(spec.conv_filters)
        if n_conv:
            self.pi_conv, self.vf_conv = nn.ModuleList(), nn.ModuleList()
            cin = spec.obs_shape[2]
            for cout, k, _s in spec.conv_filters:
                for stack in (self.pi_conv, self.vf_conv):
                    stack.append(_Layer(_orthogonal((k, k, cin, cout), math.sqrt(2), gen), torch.zeros(cout)))
                cin = cout
            din = _conv_out_dim(spec)
        else:
            din = spec.obs_dim
        self.pi, self.vf = nn.ModuleList(), nn.ModuleList()
        for h in spec.hiddens:
            self.pi.append(dense(din, h, math.sqrt(2)))
            self.vf.append(dense(din, h, math.sqrt(2)))
            din = h
        self.pi_out = dense(din, spec.action_dim, 0.01)
        self.vf_out = dense(din, 1, 1.0)
        if not spec.discrete and spec.free_log_std:
            self.log_std = nn.Parameter(torch.zeros(spec.action_dim))
        else:
            self.log_std = None
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.pi_out.w.device

    # -- weights in the JAX package's layout --------------------------------
    def param_tree(self) -> dict:
        """The parameters as the reference's params pytree (a nested dict of
        lists of ``{"w", "b"}``), holding this module's tensors."""
        tree = {name: [{"w": layer.w, "b": layer.b} for layer in getattr(self, name)]
                for name in ("pi", "vf", "pi_conv", "vf_conv") if hasattr(self, name)}
        tree["pi_out"] = {"w": self.pi_out.w, "b": self.pi_out.b}
        tree["vf_out"] = {"w": self.vf_out.w, "b": self.vf_out.b}
        if self.log_std is not None:
            tree["log_std"] = self.log_std
        return tree

    def get_params(self) -> dict:
        """Host copies (numpy) of :meth:`param_tree`."""
        return tree_map(lambda t: t.detach().cpu().numpy().copy(), self.param_tree())

    @torch.no_grad()
    def load_params(self, params: dict) -> "RLModule":
        """Copy a params tree (numpy arrays or tensors, the reference's keys
        and layout) into this module's parameters."""
        ours, theirs = tree_leaves(self.param_tree()), tree_leaves(params)
        if len(ours) != len(theirs):
            raise ValueError(f"params tree has {len(theirs)} leaves, the module {len(ours)}")
        for p, v in zip(ours, theirs):
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"params leaf of shape {tuple(v.shape)} where the module has {tuple(p.shape)}")
            p.copy_(v.to(p.dtype))
        return self

    # -- forwards ----------------------------------------------------------
    def _conv_torso(self, layers, x):
        """NHWC observations -> flat features in NHWC order (VALID padding,
        per-filter stride)."""
        act = _ACTS[self.spec.activation]
        x = x.reshape((x.shape[0],) + tuple(self.spec.obs_shape)).permute(0, 3, 1, 2)
        for layer, (_cout, _k, s) in zip(layers, self.spec.conv_filters):
            x = act(F.conv2d(x, layer.w.permute(3, 2, 0, 1), layer.b, stride=s))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, obs: torch.Tensor):
        """Returns (pi_out, value). pi_out: logits (discrete) or mean (cont)."""
        act = _ACTS[self.spec.activation]
        if self.spec.conv_filters:
            hpi = self._conv_torso(self.pi_conv, obs)
            hvf = self._conv_torso(self.vf_conv, obs)
        else:
            hpi = hvf = obs.reshape(obs.shape[0], -1)
        for layer in self.pi:
            hpi = act(hpi @ layer.w + layer.b)
        for layer in self.vf:
            hvf = act(hvf @ layer.w + layer.b)
        pi_out = hpi @ self.pi_out.w + self.pi_out.b
        value = (hvf @ self.vf_out.w + self.vf_out.b)[:, 0]
        return pi_out, value

    def _log_std(self, pi_out):
        return self.log_std if self.log_std is not None else torch.zeros(pi_out.shape[-1], device=pi_out.device)

    def sample_actions(self, obs: torch.Tensor, generator: torch.Generator | None = None, explore: bool = True):
        """Sample actions + logp + value in one forward. ``generator`` (on
        the module's device) draws the samples; the JAX package's
        ``jax.random`` draws differ, so sampled actions are not the
        reference's sample for sample."""
        pi_out, value = self(obs)
        if self.spec.discrete:
            logp_all = F.log_softmax(pi_out, dim=-1)
            if explore:
                actions = torch.multinomial(logp_all.exp(), 1, generator=generator)[:, 0]
            else:
                actions = pi_out.argmax(-1)
            logp = logp_all.gather(1, actions[:, None])[:, 0]
            return actions, logp, value
        log_std = self._log_std(pi_out)
        if explore:
            noise = torch.randn(pi_out.shape, generator=generator, device=pi_out.device, dtype=pi_out.dtype)
            actions = pi_out + noise * torch.exp(log_std)
        else:
            actions = pi_out
        return actions, gaussian_logp(actions, pi_out, log_std), value

    def action_logp_and_entropy(self, obs: torch.Tensor, actions: torch.Tensor):
        """Recompute logp/entropy/value for stored actions (training pass)."""
        pi_out, value = self(obs)
        return _logp_and_entropy(self.spec, pi_out, self._log_std(pi_out), actions) + (value,)


def action_logp_and_entropy_at(module: RLModule, params: dict, obs: torch.Tensor, actions: torch.Tensor):
    """``module.action_logp_and_entropy`` with ``params`` (parameter name ->
    tensor, as ``named_parameters`` names them) in place of the module's own
    weights: a functional call, differentiable in ``params`` (the reference's
    ``action_logp_and_entropy(params, ...)``)."""
    pi_out, value = torch.func.functional_call(module, params, (obs,))
    log_std = params["log_std"] if module.log_std is not None else module._log_std(pi_out)
    return _logp_and_entropy(module.spec, pi_out, log_std, actions) + (value,)


def _logp_and_entropy(spec: RLModuleSpec, pi_out, log_std, actions):
    if spec.discrete:
        logits = F.log_softmax(pi_out, dim=-1)
        logp = logits.gather(1, actions.long()[:, None])[:, 0]
        entropy = -torch.sum(torch.exp(logits) * logits, dim=-1)
        return logp, entropy
    logp = gaussian_logp(actions, pi_out, log_std)
    entropy = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1) * torch.ones(
        pi_out.shape[0], device=pi_out.device)
    return logp, entropy


def gaussian_logp(x, mean, log_std):
    return -0.5 * torch.sum(((x - mean) / torch.exp(log_std)) ** 2 + 2 * log_std + math.log(2 * math.pi), dim=-1)


def rl_module_params_from_jax(params: dict, spec: RLModuleSpec, *, device="cuda") -> RLModule:
    """The counterpart of the models' ``params_from_jax``: an RLModule whose
    parameters are the JAX package's params pytree (numpy arrays, as
    ``jax.tree_util.tree_map(np.asarray, params)`` gives them). Both sides
    keep the same layout (dense ``[din, dout]``, conv HWIO), so the leaves
    copy as they are; the conv torso's NHWC flatten order is kept by
    :meth:`RLModule._conv_torso`."""
    return RLModule(spec, device=device).load_params(params)


# -- the params tree, in jax.tree_util's order ------------------------------


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list/tuple in ``jax.tree_util.tree_leaves``
    order: a dict's keys sorted, a list's items in order; ``None`` is no
    leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_map(fn, tree):
    """``jax.tree_util.tree_map`` over a nested dict/list/tuple."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)


def host_tree(tree):
    """A tree of tensors as numpy copies (the JAX package's layout)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


@torch.no_grad()
def copy_into(tree, values) -> None:
    """Copy a tree of numpy arrays or tensors into ``tree``'s tensors in
    place, leaf for leaf (an optimizer keeps its hold on them)."""
    for p, v in zip(tree_leaves(tree), tree_leaves(values)):
        p.copy_(v if isinstance(v, torch.Tensor) else torch.from_numpy(np.require(v, np.float32, "W")))


def tree_unflatten_like(template, leaves: list):
    """Rebuild ``template``'s structure with ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)
