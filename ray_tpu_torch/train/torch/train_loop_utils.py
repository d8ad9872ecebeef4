"""Per-worker torch conveniences (reference: train/torch/train_loop_utils.py
prepare_model / prepare_data_loader / prepare_optimizer), on the worker's
device. ``prepare_batch`` replaces the JAX package's
``train/jax/train_loop_utils.py`` (``prepare_batch``/``shard_batch``, which
put host batches onto the mesh): it puts a host batch onto the worker's
device."""

from __future__ import annotations

from ray_tpu_torch.air import session


def get_device():
    """The device this worker trains on (``session.get_device()``); outside a
    train session, the current card. Raises when there is none: it never
    falls back to the CPU."""
    import torch

    if session.in_session() and session.get_device() is not None:
        return session.get_device()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: outside a train session get_device() is the current card"
        )
    return torch.device("cuda", torch.cuda.current_device())


def prepare_batch(batch: dict) -> dict:
    """A host batch (numpy arrays or tensors) -> tensors on this worker's
    device."""
    import torch

    device = get_device()
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def prepare_model(model, *, ddp_kwargs: dict | None = None):
    """Move the model to this worker's device and wrap it in
    DistributedDataParallel when a process group of more than one rank is
    live (reference: prepare_model, minus amp)."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    device = get_device()
    model = model.to(device)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        kwargs = dict(ddp_kwargs or {})
        if device.type == "cuda":
            kwargs.setdefault("device_ids", [device.index])
        return DistributedDataParallel(model, **kwargs)
    return model


def prepare_data_loader(data_loader, *, add_dist_sampler: bool = True):
    """Re-create the DataLoader with a DistributedSampler so each rank sees
    its shard (reference: prepare_data_loader)."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader, SequentialSampler
    from torch.utils.data.distributed import DistributedSampler

    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
        return data_loader
    if not add_dist_sampler or isinstance(data_loader.sampler, DistributedSampler):
        return data_loader
    sampler = DistributedSampler(
        data_loader.dataset,
        num_replicas=dist.get_world_size(),
        rank=dist.get_rank(),
        shuffle=not isinstance(data_loader.sampler, SequentialSampler),
    )
    return DataLoader(
        data_loader.dataset,
        batch_size=data_loader.batch_size,
        sampler=sampler,
        num_workers=data_loader.num_workers,
        collate_fn=data_loader.collate_fn,
        pin_memory=data_loader.pin_memory,
        drop_last=data_loader.drop_last,
    )


def report(metrics: dict, checkpoint=None) -> None:
    """Alias for air.session.report, for torch loops written against the
    reference's `ray.train.report`."""
    session.report(metrics, checkpoint=checkpoint)
