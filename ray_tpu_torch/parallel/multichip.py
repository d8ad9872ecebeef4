"""Multi-rank runs: a pool of rank processes and the sharded-step dryrun.

``RankPool(n)`` spawns n processes that form one ``torch.distributed``
world (NCCL with one card per rank by default; gloo with
``device="cpu"``) and run functions on every rank. ``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``: the full train step of a tiny
transformer under real dp/tp/pp and sp/ep shardings, one step per pass.
"""

from __future__ import annotations

import os
import queue
import socket
import sys
import time
import traceback


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device, inq, outq):
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        while (task := inq.get()) is not None:
            fn, args, kwargs = task
            try:
                outq.put((rank, True, fn(*args, **kwargs)))
            except BaseException:  # noqa: BLE001 — reported to the caller
                outq.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``n`` rank processes of one world, started once and reused:
    ``run(fn, *args)`` calls ``fn(*args)`` on every rank (fn importable by
    name, arguments and results picklable) and returns the results in rank
    order. A rank that raises, or a run past ``timeout``, ends the pool (a
    rank left inside a collective cannot be recovered); the next run starts
    a new one."""

    def __init__(self, n: int, device: str = "cuda"):
        if device == "cuda":
            import torch

            if n > torch.cuda.device_count():
                raise ValueError(f"{n} ranks need {n} cards; this host has {torch.cuda.device_count()}")
        self.n, self.device = n, device
        self.backend = "nccl" if device == "cuda" else "gloo"
        self._procs = []

    def _start(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        port = _free_port()
        self._outq = ctx.Queue()
        self._inqs = [ctx.Queue() for _ in range(self.n)]
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, self.n, port, self.backend, self.device, self._inqs[r], self._outq))
                       for r in range(self.n)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, timeout: float = 300, **kwargs) -> list:
        if not self._procs:
            self._start()
        for q in self._inqs:
            q.put((fn, args, kwargs))
        results, errors, pending = [None] * self.n, [], set(range(self.n))
        deadline = time.monotonic() + timeout
        while pending and not errors:
            try:
                rank, ok, value = self._outq.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in pending if not self._procs[r].is_alive()]
                if dead:
                    errors.append(f"ranks {dead} exited (code {self._procs[dead[0]].exitcode})")
                elif time.monotonic() > deadline:
                    errors.append(f"{fn.__name__} did not finish on every rank within {timeout} s")
                continue
            if not ok:
                errors.append(f"rank {rank}:\n{value}")
            results[rank] = value
            pending.discard(rank)
        if errors:
            self.close()
            raise RuntimeError(f"{fn.__name__} failed on the rank pool\n" + "\n".join(errors))
        return results

    def close(self):
        for q, p in zip(self._inqs if self._procs else [], self._procs):
            if p.is_alive():
                q.put(None)
        deadline = time.monotonic() + 10
        for p in self._procs:
            if p.pid is None:
                continue
            while p.is_alive() and time.monotonic() < deadline:
                self._drain()  # a rank cannot exit while its results sit in the queue's pipe
                p.join(timeout=0.1)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []

    def _drain(self):
        try:
            while True:
                self._outq.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --- the dryrun -----------------------------------------------------------------


def factor(n: int, ways: int) -> list[int]:
    """n split into `ways` factors, 2s first (__graft_entry__.py's rule)."""
    out = []
    for _ in range(ways - 1):
        f = 2 if n % 2 == 0 and n > 1 else 1
        out.append(f)
        n //= f
    out.append(n)
    return out


def fit(value: int, divisor: int) -> int:
    """Smallest multiple of `divisor` >= value (sharded dims divide evenly)."""
    return value if value % divisor == 0 else ((value // divisor) + 1) * divisor


# The tiny config of both passes (__graft_entry__.py's `base`), f32.
BASE = dict(vocab_size=256, d_model=64, n_layers=4, n_heads=4, n_kv_heads=4, d_ff=128, max_seq_len=64,
            remat=True)


def pass_configs(n: int) -> list[dict]:
    """The two passes of an n-rank dryrun: mesh axes, model config, attention,
    batch and sequence (the reference's sizes and its factor/fit rules)."""
    dp, tp, pp = factor(n, 3)
    sp, ep = factor(n, 2)
    return [
        dict(mesh=dict(dp=dp, tp=tp, pp=pp), attn_impl="auto", batch=fit(8, dp), seq=32,
             model=dict(BASE, n_layers=fit(BASE["n_layers"], pp), n_heads=fit(BASE["n_heads"], tp),
                        n_kv_heads=fit(BASE["n_kv_heads"], tp))),
        dict(mesh=dict(sp=sp, ep=ep), attn_impl="ring", batch=4, seq=fit(32, sp),
             model=dict(BASE, num_experts=max(ep, 2))),
    ]


def sharded_step_on_rank(spec: dict, param_seed: int = 0, batch_seed: int = 1, tokens=None, np_params=None):
    """One sharded train step on this rank (inside a RankPool): params from
    ``np_params`` (the JAX package's layout, numpy) or ``init_params(seed)``,
    placed by their logical axes; tokens [batch, seq + 1] (numpy) or drawn
    from ``batch_seed``. Returns (loss, {name: updated param as numpy}) with
    the updated params gathered whole."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    device = "cuda" if torch.cuda.is_available() and torch.distributed.get_backend() == "nccl" else "cpu"
    cfg = tt.TransformerConfig(**spec["model"], dtype=torch.float32)
    mesh = create_mesh(MeshConfig(**spec["mesh"]), device_type=device)
    params = (tt.params_from_jax(np_params, cfg, device=device) if np_params is not None
              else tt.init_params(cfg, seed=param_seed, device=device))
    params = tt.shard_params(params, cfg, mesh)
    if tokens is None:
        g = torch.Generator(device=device).manual_seed(batch_seed)
        tokens = torch.randint(0, cfg.vocab_size, (spec["batch"], spec["seq"] + 1), generator=g, device=device)
    else:
        tokens = torch.as_tensor(np.asarray(tokens), device=device)
    step = tt.make_train_step(cfg, tt.adamw(params), mesh=mesh, attn_impl=spec["attn_impl"], device=device)
    loss = float(step(params, {"tokens": tokens}))
    flat = {n: w for n, w in params.items() if n != "layers"}
    flat.update({f"layers.{n}": w for n, w in params["layers"].items()})
    return loss, {n: w.full_tensor().detach().cpu().numpy() for n, w in flat.items()}


def _pass_on_rank(spec):
    return sharded_step_on_rank(spec)[0]


def dryrun_multichip(n_devices: int, *, device: str = "cuda") -> str:
    """Run both passes' sharded step on ``n_devices`` ranks (gloo on the CPU;
    NCCL, one card per rank, on CUDA) and print the reference's line."""
    passes = pass_configs(n_devices)
    with RankPool(n_devices, device=device) as pool:
        losses = [pool.run(_pass_on_rank, spec)[0] for spec in passes]
    m1, m2 = passes[0]["mesh"], passes[1]["mesh"]
    line = (f"dryrun_multichip({n_devices}): "
            f"pass1(dp={m1['dp']},tp={m1['tp']},pp={m1['pp']}) loss={losses[0]:.4f}; "
            f"pass2(sp={m2['sp']},ep={m2['ep']},moe) loss={losses[1]:.4f}")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     device=sys.argv[2] if len(sys.argv) > 2 else "cuda")
