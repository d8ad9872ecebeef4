"""Learner + LearnerGroup — SGD on rollout batches, on the card.

Reference: rllib/core/learner/learner.py (Learner, compute_loss :900) and
learner_group.py:61 (LearnerGroup of remote learner actors, DDP-wrapped in
torch). The loss is a function of the module and the batch; the update is
one backward and the optimizer step. The JAX package's optimizer is
``optax.chain(clip_by_global_norm(grad_clip), adam(lr) | sgd(lr))``;
:class:`OptaxChain` computes the same chain as optax does (its clip is not
``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm). Data
parallelism over learners is an allreduce of gradients through the port's
``util/collective`` (a gloo group of CPU learners; learners on several cards
would form an NCCL group, which needs more than one card: ROADMAP 5b).

:func:`pack_weights` / :func:`unpack_weights` flatten a params tree into one
f32 vector in ``jax.tree_util``'s leaf order (dict keys sorted, lists in
order), so a packed vector equals the reference's bit for bit. The Podracer
device weight sync that ships that vector as a device object
(``weight_sync="device_broadcast"``, ``grad_sync="device_allreduce"``) is not
ported yet: ROADMAP A13d.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Callable, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.core.rl_module import (
    RLModule,
    _device,
    tree_leaves,
    tree_unflatten_like,
)
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

logger = logging.getLogger(__name__)

PODRACER = (
    "the Podracer device weight sync (device-object broadcast of packed weights, "
    "grad_sync='device_allreduce') is not ported yet: ROADMAP A13d"
)


def pack_weights(params) -> torch.Tensor:
    """Flatten a params tree (nested dict/list of arrays or tensors, or an
    RLModule) into ONE contiguous float32 vector, in jax's tree-flatten
    order."""
    if isinstance(params, RLModule):
        params = params.param_tree()
    leaves = [torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x.detach()
              for x in tree_leaves(params)]
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])


def unpack_weights(flat, template):
    """Rebuild a params tree from :func:`pack_weights` output. ``template``
    supplies structure, shapes and dtypes (numpy leaves give numpy leaves,
    tensors give tensors), so no structure ever crosses the wire."""
    flat = torch.as_tensor(np.asarray(flat)) if not isinstance(flat, torch.Tensor) else flat
    leaves = tree_leaves(template)
    sizes = [int(np.prod(leaf.shape)) if len(leaf.shape) else 1 for leaf in leaves]
    if sum(sizes) != flat.shape[0]:
        raise ValueError(
            f"packed weight vector has {flat.shape[0]} elements, template "
            f"expects {sum(sizes)} — learner and sampler disagree on the module spec"
        )
    out, offset = [], 0
    for leaf, n in zip(leaves, sizes):
        piece = flat[offset:offset + n].reshape(tuple(leaf.shape))
        if isinstance(leaf, torch.Tensor):
            out.append(piece.to(device=leaf.device, dtype=leaf.dtype))
        else:
            out.append(piece.cpu().numpy().astype(np.asarray(leaf).dtype))
        offset += n
    return tree_unflatten_like(template, out)


class OptaxChain:
    """``optax.chain(clip_by_global_norm(grad_clip)?, adam(lr) | sgd(lr))``,
    and ``optax.adamw(lr, weight_decay=...)`` with ``weight_decay``, computed
    as optax computes them, on a list of tensors:

    - clip: every gradient becomes ``(g / g_norm) * max_norm`` once the global
      norm ``g_norm`` reaches ``max_norm`` (no epsilon), else stays;
    - adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
      ``u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``, with t the
      step count from 1;
    - adamw adds ``weight_decay * p`` to ``u``;
    - ``p += -lr * u`` (sgd: ``u = g``).

    The clip's choice is a ``torch.where`` on the card, so a step makes no
    host sync."""

    def __init__(self, params: list, lr: float, grad_clip: Optional[float] = None, optimizer: str = "adam",
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0):
        if optimizer not in ("adam", "sgd"):
            raise ValueError(f"optimizer {optimizer!r}: 'adam' or 'sgd'")
        self.params = list(params)
        self.lr, self.grad_clip, self.optimizer = lr, grad_clip, optimizer
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.count = 0
        if optimizer == "adam":
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: list, g_norm: Optional[torch.Tensor] = None) -> None:
        """One step from ``grads`` (in ``params``' order); ``g_norm``, their
        global norm, is needed only to clip."""
        grads = list(grads)
        if self.grad_clip:
            keep = g_norm < self.grad_clip
            grads = [torch.where(keep, g, (g / g_norm) * self.grad_clip) for g in grads]
        if self.optimizer == "sgd":
            torch._foreach_add_(self.params, grads, alpha=-self.lr)
            return
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        # optax's bias corrections are f32: 1 - decay ** count.
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(updates, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, updates, alpha=-self.lr)

    def state_dict(self) -> dict:
        state = {"count": self.count}
        if self.optimizer == "adam":
            state["mu"] = [m.detach().cpu().numpy().copy() for m in self.mu]
            state["nu"] = [n.detach().cpu().numpy().copy() for n in self.nu]
        return state

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        if self.optimizer == "adam":
            for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
                dst.copy_(torch.as_tensor(src))


def global_norm(grads: list) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum of every element's square."""
    return torch.stack([g.square().sum() for g in grads]).sum().sqrt()


@contextlib.contextmanager
def full_f32(device: torch.device):
    """Inside, f32 matmuls and cuDNN convolutions on the card run in full
    f32, not TF32 (cuDNN's convolutions default to TF32), so a learner on the
    card computes what the same learner on the CPU does. Scoped: the flags
    return to their values on exit."""
    if device.type != "cuda":
        yield
        return
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def to_device(batch: dict, device: torch.device) -> dict:
    """A host batch (numpy columns) -> tensors on ``device``; ints stay ints
    (the loss casts), bools become the loss's float."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.require(v, requirements="W"))  # a store object is read-only: copy it then
        if t.dtype == torch.float64:
            t = t.to(torch.float32)
        out[k] = t.to(device, non_blocking=True)
    return out


class Learner:
    """Single-process learner: an RLModule, its optimizer and the update.

    ``device`` is where the module and the update live: the card by default
    (it raises without one unless ``device='cpu'``). ``use_mesh=True``
    (the JAX package's Podracer learner mesh, params replicated and the batch
    sharded over every local device) runs the same update on this one
    device; a process group of more than one rank raises (ROADMAP A9f)."""

    def __init__(self, spec, loss_fn: Callable, lr: float = 5e-5, grad_clip: Optional[float] = None, seed: int = 0,
                 optimizer: str = "adam", use_mesh: bool = False, *, device="cuda"):
        self.device = _device(device)
        if use_mesh and torch.distributed.is_available() and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise NotImplementedError(
                "a learner mesh over more than one rank is not ported yet: ROADMAP A9f")
        self.spec = spec
        self.loss_fn = loss_fn
        self.module = RLModule(spec, seed, device=self.device)
        self.opt = OptaxChain(list(self.module.parameters()), lr, grad_clip, optimizer)

    def compute_grads(self, batch: SampleBatch, loss_cfg: dict):
        """(loss, metrics, grads) of one batch, the grads in parameter order."""
        tb = to_device(batch, self.device)
        with full_f32(self.device):
            loss, metrics = self.loss_fn(self.module, tb, self.spec, loss_cfg)
            grads = torch.autograd.grad(loss, self.opt.params)
        return loss, metrics, grads

    def update(self, batch: SampleBatch, loss_cfg: dict) -> dict:
        loss, metrics, grads = self.compute_grads(batch, loss_cfg)
        g_norm = global_norm(grads)
        with full_f32(self.device):
            self.opt.step(grads, g_norm)
        return _host_metrics(metrics, loss, g_norm)

    def get_weights(self) -> dict:
        return self.module.get_params()

    def set_weights(self, weights) -> None:
        self.module.load_params(weights)

    def device_info(self) -> dict:
        """Where this learner runs: its device, process and card name."""
        dev = self.device
        return {"device": str(dev), "pid": os.getpid(),
                "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


def _host_metrics(metrics: dict, loss, g_norm=None) -> dict:
    """The metrics as floats, read from the card in one transfer."""
    names = list(metrics) + ["total_loss"] + (["grad_norm"] if g_norm is not None else [])
    vals = [metrics[k] for k in metrics] + [loss] + ([g_norm] if g_norm is not None else [])
    host = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=loss.device).detach().reshape(())
                        for v in vals]).cpu().tolist()
    return dict(zip(names, host))


class _RemoteLearner:
    """Learner living in its own actor; grads allreduced through the
    collective plane before the optimizer step (reference: DDP learners)."""

    def __init__(self, spec, loss_fn, lr, grad_clip, seed, rank, world_size, group_name, use_mesh=False,
                 grad_sync="host", optimizer="adam", device="cpu"):
        if grad_sync != "host":
            raise NotImplementedError(PODRACER)
        self.rank = rank
        self.world_size = world_size
        self.group_name = group_name
        self.learner = Learner(spec, loss_fn, lr, grad_clip, seed, optimizer, use_mesh=use_mesh, device=device)

    def device_info(self) -> dict:
        return self.learner.device_info()

    def init_collective(self, world, backend):
        from ray_tpu_torch.util import collective

        collective.init_collective_group(
            world_size=self.world_size, rank=self.rank, backend=backend, group_name=self.group_name
        )
        return True

    def init_weight_collective(self, world_size, rank, backend, group_name):
        raise NotImplementedError(PODRACER)

    def update(self, batch: SampleBatch, loss_cfg: dict) -> dict:
        if self.world_size > 1:
            # Data-parallel grad sync: compute grads, allreduce, then step.
            from ray_tpu_torch.util import collective

            learner = self.learner
            loss, metrics, grads = learner.compute_grads(batch, loss_cfg)
            reduced = [collective.allreduce(g / self.world_size, group_name=self.group_name) for g in grads]
            with full_f32(learner.device):
                learner.opt.step(reduced, global_norm(reduced))
            return _host_metrics(metrics, loss)
        return self.learner.update(batch, loss_cfg)

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        self.learner.set_weights(weights)
        return True


class LearnerGroup:
    """Local learner or a gang of learner actors (reference:
    learner_group.py:61). num_learners=0 -> in-process on ``device`` (the
    common single-host case); >0 -> remote actors with grad allreduce, each
    holding ``num_gpus_per_learner`` of the runtime's GPU resource. A remote
    learner on the card (``device='cuda'``) must hold a GPU; several learners
    on cards need more than one card (ROADMAP 5b)."""

    def __init__(self, spec, loss_fn, *, lr=5e-5, grad_clip=None, seed=0,
                 num_learners: int = 0, num_gpus_per_learner: float = 0,
                 collective_backend: str = "gloo", group_name: str = "rllib_learners",
                 use_mesh: bool = False, grad_sync: str = "host", optimizer: str = "adam", device="cuda"):
        if grad_sync != "host":
            raise NotImplementedError(PODRACER)
        self._local: Optional[Learner] = None
        self._actors: list = []
        dev = torch.device(device)
        if num_learners <= 0:
            self._local = Learner(spec, loss_fn, lr, grad_clip, seed, optimizer, use_mesh=use_mesh, device=dev)
            return
        if dev.type == "cuda":
            if not num_gpus_per_learner:
                raise ValueError("a learner actor on the card needs num_gpus_per_learner > 0")
            if num_learners > 1:
                raise NotImplementedError(
                    "learners on more than one card (an NCCL group of several ranks) are not ported yet: ROADMAP 5b")
        cls = ray_tpu_torch.remote(num_cpus=1, num_gpus=num_gpus_per_learner or None)(_RemoteLearner)
        self._actors = [
            cls.remote(spec, loss_fn, lr, grad_clip, seed, rank, num_learners, group_name, use_mesh, grad_sync,
                       optimizer, str(dev))
            for rank in range(num_learners)
        ]
        if num_learners > 1:
            ray_tpu_torch.get([a.init_collective.remote(num_learners, collective_backend) for a in self._actors])

    @property
    def local_learner(self) -> Optional[Learner]:
        return self._local

    def update(self, batch: SampleBatch, loss_cfg: dict) -> dict:
        if self._local is not None:
            return self._local.update(batch, loss_cfg)
        n = len(self._actors)
        bounds = self._shard_bounds(batch, n)
        refs = [
            a.update.remote(batch.slice(lo, hi), loss_cfg)
            for a, (lo, hi) in zip(self._actors, bounds)
        ]
        all_metrics = ray_tpu_torch.get(refs)
        return {k: float(np.mean([m[k] for m in all_metrics])) for k in all_metrics[0]}

    @staticmethod
    def _shard_bounds(batch: SampleBatch, n: int) -> list:
        """Split points for n shards. Sequence-structured batches (FRAG_CUT
        present, e.g. IMPALA's V-trace input) must split only at fragment
        boundaries, or time recursions would leak across shards."""
        from ray_tpu_torch.rllib.policy.sample_batch import FRAG_CUT

        total = batch.count
        if total < n:
            # Fewer rows than learners: every rank gets the whole batch —
            # identical grads allreduce to themselves, and every rank MUST
            # participate (an empty shard would NaN, a missing one would
            # hang the collective).
            return [(0, total)] * n
        if FRAG_CUT not in batch:
            return [(i * total // n, (i + 1) * total // n) for i in range(n)]
        cut_ends = [i + 1 for i, c in enumerate(np.asarray(batch[FRAG_CUT])) if c]
        if not cut_ends or cut_ends[-1] != total:
            cut_ends.append(total)
        bounds = []
        lo = 0
        for i in range(n):
            if i == n - 1:
                bounds.append((lo, total))
                break
            target = (i + 1) * total // n
            # Nearest fragment boundary at or after the even split point.
            hi = next((c for c in cut_ends if c >= max(target, lo + 1)), total)
            bounds.append((lo, hi))
            lo = hi
        if any(hi <= lo for lo, hi in bounds):
            # Fewer fragments than learners (or shuffled minibatches whose
            # cut rows landed badly): empty shards would feed NaN-producing
            # zero-length updates — fall back to a balanced row split.
            return [(i * total // n, (i + 1) * total // n) for i in range(n)]
        return bounds

    def device_info(self) -> list:
        """Where each learner runs: ``[{"device", "pid", "device_name"}]``."""
        if self._local is not None:
            return [self._local.device_info()]
        return ray_tpu_torch.get([a.device_info.remote() for a in self._actors])

    def stop(self):
        """Kill remote learner actors (they hold GPU/CPU reservations)."""
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._actors = []

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        return ray_tpu_torch.get(self._actors[0].get_weights.remote())

    def set_weights(self, weights):
        if self._local is not None:
            self._local.set_weights(weights)
        else:
            ray_tpu_torch.get([a.set_weights.remote(weights) for a in self._actors])

    # ---- Podracer weight sync (device-object broadcast path): ROADMAP A13d ----

    def init_weight_collective(self, world_size: int, rank: int, backend: str, group_name: str):
        raise NotImplementedError(PODRACER)

    def weight_group_roster(self, group_name: str):
        raise NotImplementedError(PODRACER)

    def pack_weight_ref(self):
        raise NotImplementedError(PODRACER)
