"""The flagship transformer's train loop, for ``TorchTrainer`` workers.

The port of ``bench.py``'s ``train_loop`` (bench.py:23-206): it builds the
flagship decoder on the worker's device (``session.get_device()``), trains it
on one fixed batch, and measures the framework's overhead the same way. After
``warmup`` steps (each loss reported), ``rounds`` ABBA-ordered pairs of
chunks of ``chunk`` steps run: a *raw* chunk is a tight loop that ends in one
``.item()``; a *framework* chunk reports every loss through the session with
the lagged logger — losses are stacked on the device ``lag`` at a time,
copied to the host asynchronously, and read one batch late. The last report
carries the totals::

    tokens_per_sec_framework, tokens_per_sec_raw, ratio (raw time over
    framework time; BASELINE.md's target is >= 0.90), device_name,
    launches (the flash kernels' launch counts in this worker over the loop),
    steps, first_loss, start_time, first_report_time and end_time
    (time.time() as the loop starts, at its first report and as the last
    step's work is done), peak_memory_bytes (CUDA only),
    n_params, pid (the worker's process id), and device_us: after the
    rounds, ``profile_steps`` more steps run under ``torch.profiler``, and
    this maps each device operation's name to its device microseconds over
    them (empty on the CPU)

``config`` holds ``model`` (``TransformerConfig`` fields), ``dtype`` (the
activation dtype's name), ``batch``, ``seq``, ``warmup``, ``rounds``,
``chunk``, ``lag``, ``profile_steps``, and either ``params`` (the JAX package's parameter
pytree as numpy, through ``params_from_jax``) or ``param_seed``, and either
``tokens`` ([batch, seq + 1] integers) or ``batch_seed``, and ``mesh``
(default False): True trains on ``session.get_mesh()``, the params placed by
``shard_params`` and the batch sharded over its ``dp`` axis (the final
report then carries the mesh's axis sizes as ``mesh``). Weights from a
seed and the batch from a seed are drawn exactly as
``init_params(cfg, seed)`` and ``torch.randint`` on a generator seeded
``batch_seed`` on the worker's device draw them.

``dataset_loop`` trains the same model on the trainer's dataset instead of
one fixed batch: one epoch of the worker's shard through
``iter_torch_batches`` (the ingest path).
"""

from __future__ import annotations

import collections
import os
import time


def train_loop(config: dict) -> None:
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.ops import attention

    start_time = time.time()
    device = session.get_device()
    cuda = device.type == "cuda"
    batch, seq = config["batch"], config["seq"]
    warmup, rounds = config.get("warmup", 2), config.get("rounds", 4)
    chunk = config.get("chunk", 8)
    lag = max(1, min(config.get("lag", 4), chunk))
    mesh = session.get_mesh() if config.get("mesh") else None
    cfg, params, n_params, step = _model(config, device, mesh)
    if "tokens" in config:
        tokens = torch.as_tensor(config["tokens"]).to(device)
    else:
        g = torch.Generator(device=device).manual_seed(config.get("batch_seed", 1))
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=g, device=device)
    if mesh is not None:
        tokens = tt.place_batch(tokens, mesh)
    batch_arr = {"tokens": tokens}
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    attention.reset_launch_counts()

    first = None
    for i in range(warmup):
        loss = step(params, batch_arr).item()
        now = time.time()
        session.report({"step": i, "loss": loss, "warmup": True})
        first = first or (loss, now)

    def run_raw_chunk():
        t0 = time.perf_counter()
        for _ in range(chunk):
            loss = step(params, batch_arr)
        loss.item()
        return time.perf_counter() - t0

    fw_step = warmup

    def run_fw_chunk():
        nonlocal fw_step
        logger = _LaggedLogger(session, lag, cuda)
        t0 = time.perf_counter()
        for _ in range(chunk):
            logger.append(fw_step, step(params, batch_arr))
            fw_step += 1
        logger.drain()
        return time.perf_counter() - t0

    raw_s = fw_s = 0.0
    for r in range(rounds):
        if r % 2 == 0:
            raw_s += run_raw_chunk()
            fw_s += run_fw_chunk()
        else:
            fw_s += run_fw_chunk()
            raw_s += run_raw_chunk()

    profile_steps = config.get("profile_steps", 0)
    device_us = _profile(lambda: step(params, batch_arr).item(), profile_steps, cuda) if profile_steps else {}

    tok = batch * seq * rounds * chunk
    final = {
        "final": True,
        "device_name": torch.cuda.get_device_name(device) if cuda else "cpu",
        "launches": attention.launch_counts(),
        "steps": warmup + 2 * rounds * chunk + profile_steps,
        "n_params": n_params,
        "start_time": start_time,
        "end_time": time.time(),
        "pid": os.getpid(),
        "device_us": device_us,
    }
    if mesh is not None:
        final["mesh"] = mesh.axes
    if first is not None:
        final.update(first_loss=first[0], first_report_time=first[1])
    if rounds:
        final.update(tokens_per_sec_framework=tok / fw_s, tokens_per_sec_raw=tok / raw_s, ratio=raw_s / fw_s)
    if cuda:
        final["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    session.report(final)


def _model(config: dict, device, mesh=None):
    """(cfg, params, n_params, train step) from ``config``'s ``model``,
    ``dtype`` and ``params`` or ``param_seed``, on ``device``."""
    import torch

    from ray_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(**config["model"], dtype=getattr(torch, config.get("dtype", "bfloat16")))
    if "params" in config:
        params = tt.params_from_jax(config["params"], cfg, device=device)
    else:
        params = tt.init_params(cfg, seed=config.get("param_seed", 0), device=device)
    n_params = tt.num_params(params)
    if mesh is not None:
        params = tt.shard_params(params, cfg, mesh)
    return cfg, params, n_params, tt.make_train_step(cfg, tt.adamw(params), mesh=mesh, device=device)


def dataset_loop(config: dict) -> None:
    """The flagship step fed by the trainer's dataset: one epoch of
    ``session.get_dataset_shard("train").iter_torch_batches(
    batch_size=config["batch"], drop_last=True)`` on the worker's device. Each batch holds ``inputs`` and ``targets`` ([B, T],
    the targets the inputs shifted by one), joined on the device into the
    step's ``tokens`` [B, T+1]. The first step runs alone (its loss read at
    once); the rest are issued back to back and their losses read at the
    end. Each step's loss is reported; the last report carries:

        steps, losses, first_loss, wait_ms (host ms in each ``next()`` on
        the iterator), step_ms (each step's span: CUDA events on a card, the
        host clock with a synchronous step elsewhere), tokens_per_sec (the
        steps after the first, host clock to a synchronize), row_keys (each
        row's first 4 input tokens, in order), batch_devices (the devices the
        batches arrived on), launches (the flash kernels' counts in this
        worker), device_name, pid

    ``config`` holds ``model``, ``dtype``, ``batch`` and ``params`` or
    ``param_seed``, as ``train_loop``'s.
    """
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.ops import attention

    device = session.get_device()
    cuda = device.type == "cuda"
    _, params, _, step = _model(config, device)
    attention.reset_launch_counts()
    it = iter(session.get_dataset_shard("train").iter_torch_batches(batch_size=config["batch"], drop_last=True))
    losses, keys, devices, wait_ms, marks = [], [], set(), [], []
    t_rest = None
    while True:
        t0 = time.perf_counter()
        try:
            b = next(it)
        except StopIteration:
            break
        wait_ms.append((time.perf_counter() - t0) * 1e3)
        devices.update(str(t.device) for t in b.values())
        keys.append(b["inputs"][:, :4])
        tokens = torch.cat([b["inputs"], b["targets"][:, -1:]], dim=1)
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(params, {"tokens": tokens}))
            end.record()
            marks.append((start, end))
        else:
            t1 = time.perf_counter()
            losses.append(step(params, {"tokens": tokens}))
            marks.append((time.perf_counter() - t1) * 1e3)
        if len(losses) == 1:
            session.report({"step": 0, "loss": losses[0].item()})
            t_rest = time.perf_counter()
    if cuda:
        torch.cuda.synchronize(device)
    rest_s = time.perf_counter() - t_rest if t_rest is not None else 0.0
    values = torch.stack(losses).tolist() if losses else []
    for i, loss in enumerate(values[1:], 1):
        session.report({"step": i, "loss": loss})
    seq = b["inputs"].shape[1] if keys else 0
    session.report({
        "final": True,
        "steps": len(values),
        "losses": values,
        "first_loss": values[0] if values else None,
        "wait_ms": wait_ms,
        "step_ms": [s.elapsed_time(e) for s, e in marks] if cuda else marks,
        "tokens_per_sec": (len(values) - 1) * config["batch"] * seq / rest_s if len(values) > 1 else None,
        "row_keys": torch.cat(keys).tolist() if keys else [],
        "batch_devices": sorted(devices),
        "launches": attention.launch_counts(),
        "device_name": torch.cuda.get_device_name(device) if cuda else "cpu",
        "pid": os.getpid(),
    })


def _profile(run, steps: int, cuda: bool) -> dict:
    """``steps`` calls of ``run`` under torch.profiler; each device
    operation's self device time in microseconds over all of them (kernels,
    copies and sets, not the annotations of CPU ranges on the device's
    timeline)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(steps):
            run()
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)}


class _LaggedLogger:
    """bench.py's framework logger: losses are stacked on the device ``lag``
    at a time, each stack is copied to the host asynchronously, and a stack
    is read (and its losses reported, in order) only once the next one is in
    flight; ``drain`` reports the rest."""

    def __init__(self, session, lag: int, cuda: bool):
        self.session, self.lag, self.cuda = session, lag, cuda
        self.tail: list = []
        self.base = None
        self.inflight: collections.deque = collections.deque()

    def append(self, step: int, loss) -> None:
        if not self.tail:
            self.base = step
        self.tail.append(loss)
        if len(self.tail) == self.lag:
            self._launch()
            if len(self.inflight) > 1:
                self._flush(*self.inflight.popleft())

    def _launch(self) -> None:
        import torch

        stacked = torch.stack(self.tail)
        if self.cuda:
            host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
            host.copy_(stacked, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = stacked, None
        self.inflight.append((self.base, host, done))
        self.tail = []

    def _flush(self, base: int, host, done) -> None:
        if done is not None:
            done.synchronize()
        for j, val in enumerate(host.tolist()):
            self.session.report({"step": base + j, "loss": val})

    def drain(self) -> None:
        if self.tail:
            self._launch()
        while self.inflight:
            self._flush(*self.inflight.popleft())
