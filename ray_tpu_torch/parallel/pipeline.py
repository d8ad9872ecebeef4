"""Pipeline parallelism over the ``pp`` mesh axis (GPipe).

Counterpart of ``ray_tpu/parallel/pipeline.py``: layer parameters are
stacked ``[n_stages, ...]`` and each rank of the ``pp`` axis holds its
stage's slice; the batch splits into microbatches, and over
``M + n_stages - 1`` schedule steps stage 0 ingests microbatch t while the
activations move forward stage to stage by point-to-point sends. The last
stage's outputs are made common to every stage by an ``all_reduce`` over
``pp`` (the reference's masked ``psum``).

The JAX version is differentiable by autodiff; here an autograd Function
keeps each (stage, microbatch) graph of the forward and its backward runs the
reverse schedule: the last stage takes the output's gradient, and each stage
sends its input's gradient back to the previous one. Stage s runs
microbatch t - s at step t only when that microbatch exists: the reference
also runs the bubble's steps on zeros and discards them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree


class _SumGradOver(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``. For a
    tensor every rank of the group holds whole (replicated) of which each
    rank uses a part: each rank's gradient then is the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, treedef, pipe, x_mbs, *leaves):
        group, n, stage = pipe
        M = x_mbs.shape[0]
        peer = lambda s: dist.get_global_rank(group, s)  # noqa: E731
        keep = any(ctx.needs_input_grad)
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        tree = pytree.tree_unflatten(params, treedef)
        outputs = torch.zeros_like(x_mbs)
        graphs, sends = [], []
        with torch.set_grad_enabled(keep):
            for t in range(M + n - 1):
                m = t - stage  # the microbatch this stage runs at step t
                if not 0 <= m < M:
                    continue
                if stage == 0:
                    inp = x_mbs[m].detach()
                else:
                    inp = torch.empty_like(x_mbs[0])
                    dist.recv(inp, src=peer(stage - 1), group=group)
                inp.requires_grad_(keep)
                y = stage_fn(tree, inp)
                graphs.append((inp, y))
                if stage < n - 1:
                    sends.append(dist.isend(y.detach().contiguous(), dst=peer(stage + 1), group=group))
                else:
                    outputs[m] = y.detach()
        for w in sends:
            w.wait()
        if n > 1:
            dist.all_reduce(outputs, group=group)  # only the last stage's are non-zero
        ctx.pipe, ctx.graphs, ctx.params = pipe, graphs, params
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        group, n, stage = ctx.pipe
        peer = lambda s: dist.get_global_rank(group, s)  # noqa: E731
        wanted = [p for p in ctx.params if p.requires_grad]
        g_params = [torch.zeros_like(p) for p in wanted]
        g_x = torch.zeros_like(g_out)
        sends = []
        for m in reversed(range(len(ctx.graphs))):  # every stage runs every microbatch
            inp, y = ctx.graphs[m]
            if stage == n - 1:
                g_y = g_out[m]
            else:
                g_y = torch.empty_like(y)
                dist.recv(g_y, src=peer(stage + 1), group=group)
            grads = torch.autograd.grad(y, [inp] + wanted, g_y, allow_unused=True)
            for acc, g in zip(g_params, grads[1:]):
                if g is not None:
                    acc += g
            g_in = grads[0] if grads[0] is not None else torch.zeros_like(inp)
            if stage > 0:
                sends.append(dist.isend(g_in.contiguous(), dst=peer(stage - 1), group=group))
            else:
                g_x[m] = g_in
        for w in sends:
            w.wait()
        ctx.graphs = None
        it = iter(g_params)
        return (None, None, None, g_x) + tuple(next(it) if p.requires_grad else None for p in ctx.params)


def _stage_slice(leaf, mesh, axis_name: str, stage: int, n: int):
    """This stage's slice of a stacked leaf [n_stages, ...]: a DTensor is
    resharded to Shard(0) over the axis (a local slice) and its local part
    taken; a plain tensor, which every rank holds whole, is indexed, and its
    gradient summed over the axis so every rank holds the whole gradient."""
    from torch.distributed.tensor import DTensor, Shard

    if leaf.shape[0] != n:
        raise ValueError(f"stacked params have {leaf.shape[0]} stages; the {axis_name} axis has {n}")
    if isinstance(leaf, DTensor):
        placements = [Shard(0) if name == axis_name else p for name, p in zip(mesh.dim_names, leaf.placements)]
        return leaf.redistribute(leaf.device_mesh, placements).to_local()[0]
    if n > 1 and leaf.requires_grad:
        leaf = _SumGradOver.apply(leaf, mesh.group(axis_name))
    return leaf[stage]


def pipeline_apply(stage_fn, stacked_params, x, mesh, *, axis_name: str = "pp",
                   num_microbatches: int | None = None):
    """Run ``n_stages`` stacked stages over microbatched input.

    stage_fn(params_slice, x_mb) -> y_mb, where activations keep one shape
    and dtype. stacked_params: a tensor or nested dict of tensors with
    leading dim n_stages (DTensors, or plain tensors every rank holds
    whole). x: [num_microbatches * mb, ...], the same on every rank of the
    axis. Returns y with x's batch shape, the same on every rank.
    """
    from torch.distributed.tensor import DTensor

    n_stages = mesh.shape[axis_name]
    B = x.shape[0]
    M = num_microbatches or n_stages
    assert B % M == 0, f"batch {B} not divisible by microbatches {M}"
    group, stage = mesh.group(axis_name), mesh.index(axis_name)
    leaves, treedef = pytree.tree_flatten(stacked_params)
    local = [_stage_slice(p, mesh, axis_name, stage, n_stages) for p in leaves]
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if n_stages > 1 and x.requires_grad:
        x = _SumGradOver.apply(x, group)
    x_mbs = x.reshape(M, B // M, *x.shape[1:])
    y = _GPipe.apply(stage_fn, treedef, (group, n_stages, stage), x_mbs, *local)
    return y.reshape(B, *y.shape[2:])
