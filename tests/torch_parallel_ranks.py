"""Per-rank programs for the port's multi-rank tests (test_torch_parallel.py,
test_torch_sharded_step.py). Each runs on every rank of a
``ray_tpu_torch.parallel.multichip.RankPool`` (4 gloo ranks) and returns
numpy arrays. This module imports no JAX: the ranks never load it."""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh, logical_to_spec, spec_to_placements


def _mesh(axes: dict):
    return create_mesh(MeshConfig(**axes), device_type="cpu")


def mesh_layout(axes: dict):
    """This rank's mesh: the six sizes, its index on each live axis, each
    live axis's group size and the DeviceMesh's rank grid."""
    mesh = _mesh(axes)
    live = [a for a, s in mesh.shape.items() if s > 1]
    return (mesh.shape, {a: mesh.index(a) for a in live},
            {a: torch.distributed.get_world_size(mesh.group(a)) for a in live},
            mesh.device_mesh.mesh.tolist(), mesh.dim_names)


def local_shards(axes: dict, cases: list):
    """For each (logical axes, global array): this rank's shard of the
    array distributed by logical_to_spec -> spec_to_placements."""
    mesh = _mesh(axes)
    out = []
    for logical, arr in cases:
        t = torch.as_tensor(arr)
        placements = spec_to_placements(logical_to_spec(logical), mesh, t.dim())
        out.append(distribute_tensor(t, mesh.device_mesh, placements).to_local().numpy())
    return out


def attention(kind: str, axes: dict, q, k, v, causal: bool, grads: bool = False, impl: str = "auto"):
    """Ring or Ulysses attention over sp of whole q, k, v (numpy, the same on
    every rank): the gathered output, and with ``grads`` the gradients of
    its sum with respect to q, k and v."""
    from ray_tpu_torch.parallel.ring_attention import ring_attention
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh(axes)
    if grads:  # leaves sharded over sp, so that each gradient is whole
        placements = [Shard(1) if n == "sp" else Replicate() for n in mesh.dim_names]
        q, k, v = (distribute_tensor(torch.tensor(x), mesh.device_mesh, placements).requires_grad_()
                   for x in (q, k, v))
    else:
        q, k, v = (torch.tensor(x) for x in (q, k, v))
    if kind == "ring":
        out = ring_attention(q, k, v, mesh, causal=causal, impl=impl)
    else:
        out = ulysses_attention(q, k, v, mesh, causal=causal)
    assert isinstance(out, DTensor) and out.placements[mesh.dim_names.index("sp")].is_shard(1), out.placements
    whole = out.full_tensor()
    if not grads:
        return whole.detach().numpy()
    whole.sum().backward()
    return whole.detach().numpy(), [x.grad.full_tensor().numpy() for x in (q, k, v)]


def ring_impl_error(axes: dict):
    """What ring_attention raises for impl='cuda' on CPU tensors."""
    from ray_tpu_torch.parallel.ring_attention import ring_attention

    mesh = _mesh(axes)
    q = torch.zeros(1, 8, 2, 32)
    try:
        ring_attention(q, q, q, mesh, impl="cuda")
    except ValueError as e:
        return str(e)
    return None


def pipeline(axes: dict, ws, x, num_microbatches: int, grads: bool = False):
    """pipeline_apply of tanh(h @ w) stages; with ``grads`` also the
    gradients of the output's sum with respect to the stacked weights and x.
    An AssertionError comes back as its message."""
    from ray_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = _mesh(axes)
    ws, x = torch.tensor(ws, requires_grad=grads), torch.tensor(x, requires_grad=grads)
    try:
        y = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, x, mesh, num_microbatches=num_microbatches)
    except AssertionError as e:
        return f"AssertionError: {e}"
    if not grads:
        return y.detach().numpy()
    y.sum().backward()
    return y.detach().numpy(), ws.grad.numpy(), x.grad.numpy()


def moe_expert_parallel(axes: dict, params: dict, x, capacity_factor: float):
    """moe_layer with the experts sharded over ep (x replicated): the
    gathered output and aux, and the placements of wi."""
    from torch.distributed.tensor import Replicate, Shard

    from ray_tpu_torch.parallel.moe import moe_layer

    mesh = _mesh(axes)
    dm = mesh.device_mesh
    rep = [Replicate()] * len(mesh.dim_names)
    ep = [Shard(0) if n == "ep" else Replicate() for n in mesh.dim_names]
    placed = {n: distribute_tensor(torch.tensor(p), dm, ep if p.ndim == 3 else rep) for n, p in params.items()}
    out, aux = moe_layer(placed, distribute_tensor(torch.tensor(x), dm, rep), capacity_factor=capacity_factor,
                         mesh=mesh)
    return out.full_tensor().numpy(), aux.full_tensor().item(), str(placed["wi"].placements)


def reshard_checkpoint(path: str, np_params: dict, model: dict, axes_a: dict, axes_b: dict):
    """Save the params sharded on mesh a, restore them onto mesh b: the
    restored params gathered whole, and wq's placements on mesh b."""
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.train.torch.checkpointing import restore_sharded, save_sharded

    cfg = tt.TransformerConfig(**model, dtype=torch.float32)
    params = tt.shard_params(tt.params_from_jax(np_params, cfg, device="cpu"), cfg, _mesh(axes_a))
    save_sharded(path, params)
    like = tt.shard_params(tt.init_params(cfg, seed=1, device="cpu"), cfg, _mesh(axes_b))
    got = restore_sharded(path, like=like)
    whole = {n: w.full_tensor().numpy() for n, w in got.items() if n != "layers"}
    whole.update({f"layers.{n}": w.full_tensor().numpy() for n, w in got["layers"].items()})
    wq = got["layers"]["wq"]
    return whole, (wq.device_mesh.mesh_dim_names, tuple(repr(p) for p in wq.placements))


def sharded_step(spec: dict, np_params: dict, tokens):
    from ray_tpu_torch.parallel.multichip import sharded_step_on_rank

    return sharded_step_on_rank(spec, tokens=np.asarray(tokens), np_params=np_params)
