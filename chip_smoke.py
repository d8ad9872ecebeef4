"""Drive the PyTorch/H100 port (ray_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a card. Phases, each
printing its own lines; any failure raises and exits non-zero before the last
line:

1. device: the card's name and power limit (nvidia-smi) and torch's name.
2. build: nvcc builds the flash-attention kernels from ops/csrc (time and
   -Xptxas -v output), then each bf16 kernel's registers, shared memory and
   blocks per SM at the main head width, as the card's runtime reports them.
3. kernels vs plain: each kernel against its plain PyTorch version on the same
   inputs, bf16 and f32 at the main path's shapes plus edge cases, with the
   port's own bars (ops/attention.py MATCH_TOL); the forward without LSE
   (the no-grad path) must give the same output as with it, and a second
   backward on the same inputs the same dq, dk and dv bit for bit (no
   atomics).
4. main path: the flagship transformer at full width (bench.py's TPU config,
   ~168M params, random weights from a seed) trains on one fixed batch through
   init_params / adamw / make_train_step; the loss must be finite and fall and
   every kernel must have been launched 8 times per step. Three more steps
   run under torch.profiler: each flash kernel's device time per step and the
   device-busy share of a step. Then the config's defaults (fused loss,
   remat): a warm-up step, three timed steps and one profiled step.
5. timings: each kernel, its plain version and one PyTorch library call for
   the same function, with CUDA events, beside the card's bound.
6. serve: the serving path (models/generate.py, serve/llm) at the flagship
   config. bf16 function checks: ragged prefill's last-row logits against
   forward (the flash kernel) on each row's own prompt, and the paged decode
   chunk against the dense one on the same cache contents, both within the
   kernel bars. f32 engine exactness: at full width and 2 layers, with a pool
   small enough to preempt, every greedy request's tokens equal generate()'s.
   bf16 traffic at full width and depth: 16 closed-loop streams over 8 slots
   until 48 requests finish (a shared 64-token system prefix, seeded
   suffixes, geometric output lengths, a quarter sampled); prints output
   tokens/s, TTFT p50/p99, TPOT, the decode tick, the prefix hits,
   preemptions, KV pool and peak memory, then profiles ~20 decode ticks with
   every slot busy (device-busy share, by kind of kernel). Every greedy
   request is then teacher-forced through forward: each emitted token's
   logit must lie within SERVE_LOGIT_BAR of its row's maximum.
7. trainer: the port's runtime and trainer drive the main path's train step
   in a worker process: ray_tpu_torch.init(num_cpus=4, num_gpus=1), then
   TorchTrainer(train_loop, ScalingConfig(num_workers=1, use_gpu=True)).fit()
   with the flagship loop (ray_tpu_torch/train/flagship_loop.py, the port of
   bench.py's train_loop) at the main path's config, weights from seed 0 and
   the batch from seed 1: two warm-up steps, then ABBA-ordered raw and
   framework chunks of 8 steps, then 3 steps under torch.profiler in the
   worker. Prints the worker's card, its own kernel launch counts, its first
   loss beside the main path's, framework and raw tokens/s and their ratio,
   its device ms per step by kind and its device-busy share (the profiled
   device time over the raw step), its peak memory and the time from init()
   to its first report; fails unless the card is the driver's, each kernel
   ran 8x per step in the worker, the first loss is the main path's within
   TRAINER_LOSS_RTOL, the loop ran in a process of its own, and shutdown()
   leaves neither that process nor any other worker behind.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Without a card it exits 1 and prints neither.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, at 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
MAIN = dict(B=12, T=1024, H=8, D=128)  # attention shapes of the main path
STEPS = 10  # timed train steps, after one warm-up step
PROFILED = 3  # further steps under torch.profiler, after the timed ones
KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# Which design each kernel's numbers belong to, so a row that keeps an
# earlier time can be told apart.
DESIGNS = {"flash_fwd": "mma.sync-cp.async", "flash_bwd_dkv": "mma.sync-cp.async",
           "flash_bwd_dq": "mma.sync-cp.async"}
# Kinds of device work in a train step, by words in the kernel's name (the
# first group that matches; "other" for none).
PROFILE_GROUPS = (
    ("flash attention", ("rtt::",)),
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
    ("softmax", ("SoftMax", "softmax")),
    ("optimizer", ("multi_tensor", "Adam", "adam")),
    ("copy/cast", ("copy",)),
    ("elementwise/reduce", ("elementwise", "reduce")),
)


# The serving phase. bench.py's TPU config, as the main path (bench.py:44-72).
SERVE_CFG = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8, d_ff=2816, max_seq_len=1024)
# Teacher-forced check of the bf16 traffic: the largest amount (in logits) by
# which forward's logit of an emitted greedy token may fall short of its
# row's maximum. Both sides' logits are bf16 products (the top ones, ~4 std
# above 0, lie on a grid of 2**-5); sound runs read one grid step, 0.03125.
# The bar is four steps. It is a sanity check only: it was set from sound
# runs and never read on a planted fault, and with random weights a token
# depends weakly on its context, so subtle scheduling faults may stay under
# it. The f32 exactness run (tokens equal to generate(), through prefix hits
# and preemptions at the traffic run's geometry) is the check for those.
SERVE_LOGIT_BAR = 0.125
TRAFFIC = dict(streams=16, requests=48, slots=8, block_size=16, prefill_chunk=128, prefix=64,
               suffix=(32, 448), mean_new=64, new=(8, 256), sampled_every=4)
# The f32 exactness run: prompts of the shared prefix + 32..192 tokens, 32..128
# new tokens each, and a pool (block 0 is the null block) small enough that
# decode runs it dry.
EXACT = dict(requests=8, suffix=(32, 193), new=(32, 129), num_blocks=65)
PROFILED_TICKS = 20
# The trainer phase: bench.py's loop shape at the main path's config
# (bench.py:44-71, as main_path_phase), a few rounds of 8-step chunks.
TRAINER = dict(warmup=2, rounds=4, chunk=8, lag=4, profile_steps=3)
# The worker's first loss against main_path_phase's: the same program on the
# same inputs in another process, so they differ only where a library picks
# another reduction order.
TRAINER_LOSS_RTOL = 1e-3


def _phase(name):
    print(f"== {name}", flush=True)


def device_phase(torch):
    _phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: {name}, "
          f"{torch.cuda.device_count()} device(s), capability {torch.cuda.get_device_capability(0)}")
    if torch.cuda.get_device_capability(0) != (9, 0):
        raise RuntimeError("the kernels are built for sm_90a (Hopper)")
    # f32 products of the plain versions in full f32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, name


def build_phase():
    _phase("build")
    from ray_tpu_torch.ops._build import load_kernels

    k = load_kernels()
    print(f"built {k.path} in {k.seconds:.1f} s" if k.seconds else f"cached {k.path}")
    for line in k.log.splitlines():
        print("  " + line.strip())
    info = {name: k.info(name, MAIN["D"]) for name in KERNELS}
    for name, i in info.items():
        print(f"{name} bf16 D{MAIN['D']}: {i['regs']} registers/thread, {i['smem_bytes']} B shared memory/block, "
              f"{i['threads']} threads/block, {i['blocks_per_sm']} block(s)/SM "
              f"({i['blocks_per_sm'] * i['threads'] // 32} warps), {i['local_bytes']} B local/thread")
    return info


def _inputs(torch, seed, dtype, B, Tq, Tk, H, D):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda T: torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    return mk(Tq), mk(Tk), mk(Tk), mk(Tq)  # q, k, v, dout


def kernels_phase(torch):
    _phase("kernels vs plain")
    from ray_tpu_torch.ops import attention as A

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    cases = [  # name, dtype, B, Tq, Tk, H, D, causal, window
        ("main", "bf16", MAIN["B"], MAIN["T"], MAIN["T"], MAIN["H"], MAIN["D"], True, 0),
        ("main", "f32", MAIN["B"], MAIN["T"], MAIN["T"], MAIN["H"], MAIN["D"], True, 0),
        ("tq<tk", "bf16", 2, 512, 1024, 8, 128, True, 0),
        ("window256", "bf16", 2, 1024, 1024, 8, 128, True, 256),
        ("non-causal", "bf16", 2, 1024, 1024, 8, 128, False, 0),
        ("ragged1000", "bf16", 2, 1000, 1000, 8, 128, True, 0),
        ("ragged1000", "f32", 2, 1000, 1000, 8, 128, True, 0),
        ("d64", "bf16", 2, 1024, 1024, 8, 64, True, 0),
        ("d32-window", "bf16", 2, 512, 512, 4, 32, True, 100),
        # more ragged lengths, and Tq < Tk with a bottom-right offset (832) that is no multiple of 128
        ("ragged960", "bf16", 2, 960, 960, 8, 128, True, 0),
        ("tq192<tk", "bf16", 2, 192, 1024, 8, 128, True, 0),
    ]
    main_err, failures = {}, []
    for i, (name, dt, B, Tq, Tk, H, D, causal, window) in enumerate(cases):
        q, k, v, dout = _inputs(torch, i, dtypes[dt], B, Tq, Tk, H, D)
        scale = D**-0.5
        out_ref, lse_ref = A._plain_flash_fwd(q, k, v, causal, scale, window)
        dq_ref, dk_ref, dv_ref = A._plain_flash_bwd(q, k, v, out_ref, lse_ref, dout, causal, scale, window)
        out, lse = A.flash_fwd_cuda(q, k, v, causal, scale, window, save_lse=True)
        out_primal, _ = A.flash_fwd_cuda(q, k, v, causal, scale, window, save_lse=False)
        dq, dk, dv = A.flash_bwd_cuda(q, k, v, out_ref, lse_ref, dout, causal, scale, window)
        again = A.flash_bwd_cuda(q, k, v, out_ref, lse_ref, dout, causal, scale, window)
        torch.cuda.synchronize()
        if not torch.equal(out_primal, out):
            failures.append(f"{name}/{dt}: the forward without LSE differs from the forward with it")
        failures += [f"{name}/{dt}: a second backward gives another {w}"
                     for w, x, y in zip(("dq", "dk", "dv"), (dq, dk, dv), again) if not torch.equal(x, y)]
        m = {}
        for what, got, want in (("out", out, out_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
                                ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            m[what] = A.mismatch(got, want)
            failures += [f"{name}/{dt} {what}: {x}" for x in A.over_tolerance(m[what], dtypes[dt])]
        print(f"{name:>11} {dt:>4} B{B} Tq{Tq} Tk{Tk} H{H} D{D} causal={int(causal)} window={window}: "
              + " ".join(f"{w} rel_l2={r['rel_l2']:.2e} elem={r['elem']:.2e} max_abs={r['max_abs']:.2e}"
                         for w, r in m.items()), flush=True)
        if (name, dt) == ("main", "bf16"):
            main_err = {"flash_fwd": (m["out"], m["lse"]), "flash_bwd_dkv": (m["dk"], m["dv"]),
                        "flash_bwd_dq": (m["dq"],)}
        del q, k, v, dout, out_ref, lse_ref, dq_ref, dk_ref, dv_ref, out, out_primal, lse, dq, dk, dv, again
    if failures:
        raise AssertionError("kernel disagrees with its plain version: " + "; ".join(failures))
    print(f"all {len(cases)} cases within the bars {A.MATCH_TOL}")
    return main_err


def _profile(run, steps, launches):
    """`steps` more train steps under torch.profiler. Prints each flash
    kernel's device time per step and the busiest device kernels; returns
    (device ms per step of every kernel, {flash kernel: ms per step}), or None
    when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
    # Device work only: kernels, copies and sets, not the annotations of
    # CPU ranges on the device's timeline (the optimizer step's, for one).
    us = {e.key: e.self_device_time_total for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)}
    total_ms = sum(us.values()) / 1e3 / steps
    if total_ms <= 0:
        print("in-step: not measured (the profiler recorded no device time)")
        return None
    flash = {n: sum(t for key, t in us.items() if n in key) / 1e3 / steps for n in KERNELS}
    for n, ms in flash.items():
        print(f"in-step {n}: {ms:.3f} ms per step, {ms / launches[n]:.4f} ms per launch")
    print(f"in-step device time: {total_ms:.1f} ms per step; by kind: "
          + ", ".join(f"{g} {ms:.1f} ms" for g, ms in _kinds(us, steps).items()))
    print("busiest:")
    for key, t in sorted(us.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {t / 1e3 / steps:8.3f} ms  {key[:110]}")
    return total_ms, flash


def _train(torch, tt, A, cfg, steps, batch_size, label, profiled=0):
    """Warm-up step + `steps` timed steps + `profiled` steps under the
    profiler, on one fixed batch; returns (losses, step ms, launch counts,
    peak memory, profile)."""
    params = tt.init_params(cfg, seed=0)
    opt = tt.adamw(params)
    step = tt.make_train_step(cfg, opt)
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (batch_size, MAIN["T"] + 1), generator=g, device="cuda")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()  # the main path starts here ...
    losses, ms = [], []
    for _ in range(1 + steps):
        t0 = time.perf_counter()
        loss = step(params, batch).item()  # .item() waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    prof = None
    if profiled:
        # remat recomputes each layer's forward in the backward: 2 forward launches per layer.
        launches = {n: cfg.n_layers * (2 if n == "flash_fwd" and cfg.remat else 1) for n in KERNELS}
        prof = _profile(lambda: losses.append(step(params, batch).item()), profiled, launches)
    counts = A.launch_counts()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: {tt.num_params(params) / 1e6:.1f}M params, losses {[round(x, 4) for x in losses]}")
    del params, opt, step, batch
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall ({losses[0]} -> {losses[-1]})")
    return losses, ms[1:], counts, peak, prof


def main_path_phase(torch, card):
    _phase("main path")
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.ops import attention as A

    # bench.py's TPU config (bench.py:44-72): full width, bf16 activations,
    # f32 params, remat off, unfused loss, batch 12, T 1024.
    cfg = tt.TransformerConfig(
        vocab_size=32000, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8, d_ff=2816,
        max_seq_len=1024, dtype=torch.bfloat16, param_dtype=torch.float32, remat=False,
        fused_loss=False, scan_unroll=8,
    )
    B, L = MAIN["B"], cfg.n_layers
    losses, ms, counts, peak, prof = _train(torch, tt, A, cfg, STEPS, B, "bench config", profiled=PROFILED)
    n_steps = 1 + STEPS + PROFILED
    want = {n: n_steps * L for n in counts}
    print(f"launches over {n_steps} steps: {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"main path did not launch every kernel {L}x per step: {counts}")
    med = sorted(ms)[len(ms) // 2]
    print(f"bench config on {card}: step {med:.1f} ms median of {STEPS} "
          f"(min {min(ms):.1f}, max {max(ms):.1f}), {B * MAIN['T'] / med * 1e3:.0f} tokens/s, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if prof is not None:
        print(f"device-busy share of the median step: {prof[0] / med:.1%} ({prof[0]:.1f} ms of kernels)")

    cfg2 = dataclasses.replace(cfg, fused_loss=True, remat=True)
    _, ms2, counts2, peak2, prof2 = _train(torch, tt, A, cfg2, 3, B, "defaults (fused loss, remat)", profiled=1)
    n2 = 1 + 3 + 1
    # remat recomputes each layer's forward in the backward: 2 forward launches per layer.
    want2 = {"flash_fwd": n2 * 2 * L, "flash_bwd_dkv": n2 * L, "flash_bwd_dq": n2 * L}
    print(f"launches over {n2} steps: {counts2} (expected {want2})")
    if counts2 != want2:
        raise AssertionError(f"defaults run launched {counts2}, expected {want2}")
    med2 = sorted(ms2)[1]
    print(f"defaults on {card}: step {med2:.1f} ms median of 3 (min {min(ms2):.1f}, max {max(ms2):.1f}), "
          f"{B * MAIN['T'] / med2 * 1e3:.0f} tokens/s, max_memory_allocated {peak2 / 2**30:.2f} GiB")
    if prof2 is not None:
        print(f"defaults: device-busy share of the median step: {prof2[0] / med2:.1%} ({prof2[0]:.1f} ms of kernels)")
    # in-step ms per launch of each flash kernel (empty when not measured)
    return counts, ({n: t / L for n, t in prof[1].items()} if prof else {}), losses[0], med


def _time_ms(torch, fn, iters):
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timings_phase(torch, card, counts, errs, info, in_step):
    _phase("timings")
    watts = float(card.rsplit(",", 1)[1].strip().split()[0])  # "name, 700.00 W"
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    B, T, H, D = MAIN["B"], MAIN["T"], MAIN["H"], MAIN["D"]
    scale = D**-0.5
    q, k, v, dout = _inputs(torch, 100, torch.bfloat16, B, T, T, H, D)
    out, lse = A.flash_fwd_cuda(q, k, v, True, scale, 0, save_lse=True)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()

    # Library yardstick (never called by the port): SDPA in its [B, H, T, D] layout.
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v, dout))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    with torch.no_grad():
        lib_fwd = _time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20)
    lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True), 20)
    plain_fwd = _time_ms(torch, lambda: A._plain_flash_fwd(q, k, v, True, scale, 0), 5)
    plain_bwd = _time_ms(torch, lambda: A._plain_flash_bwd(q, k, v, out, lse, dout, True, scale, 0), 5)
    fwd = _time_ms(torch, lambda: A.flash_fwd_cuda(q, k, v, True, scale, 0, save_lse=True), 20)
    dkv = _time_ms(torch, lambda: A.flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, True, scale, 0), 20)
    dq = _time_ms(torch, lambda: A.flash_bwd_dq_cuda(q, k, v, dout, lse, delta, True, scale, 0), 20)

    # Least time for the same work: FLOPs over visible (q, k) pairs at the bf16
    # tensor-core peak, bytes with each input read and each output written once.
    pairs = B * H * int(A._visible(T, T, True, 0, "cuda").sum().item())
    tensor = B * T * H * D * 2  # one bf16 [B, T, H, D] tensor
    rows = B * H * T * 4  # one f32 [B, H, T] vector (lse, delta)
    work = {  # name: (FLOPs, bytes)
        "flash_fwd": (4 * D * pairs, 3 * tensor + tensor + rows),  # QK^T, PV | q k v -> out, lse
        "flash_bwd_dkv": (8 * D * pairs, 4 * tensor + 2 * rows + 2 * tensor),  # S, dP, dV, dK
        "flash_bwd_dq": (6 * D * pairs, 4 * tensor + 2 * rows + tensor),  # S, dP, dQ
    }
    measured = {"flash_fwd": (fwd, plain_fwd, lib_fwd), "flash_bwd_dkv": (dkv, plain_bwd, lib_bwd),
                "flash_bwd_dq": (dq, plain_bwd, lib_bwd)}
    # What the timed plain and library calls compute: the backward rows' calls
    # compute all of dq, dk and dv, not only the row's kernel's share.
    covers = {"flash_fwd": ("out+lse", "out"), "flash_bwd_dkv": ("dq+dk+dv", "dq+dk+dv"),
              "flash_bwd_dq": ("dq+dk+dv", "dq+dk+dv")}
    sources = {
        "flash_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu", "ray_tpu/ops/attention.py:57"),
        "flash_bwd_dkv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu", "ray_tpu/ops/attention.py:320"),
        "flash_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu", "ray_tpu/ops/attention.py:366"),
    }
    rows_out = []
    print(f"bf16 B{B} T{T} H{H} D{D} causal, on {card}; bounds at the published H100 SXM peaks "
          f"({PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, {PEAK_BYTES / 1e12:.2f} TB/s), which assume 700 W. "
          f"plain_ms and library_ms of both backward rows are one call computing dq, dk and dv together; "
          f"the two backward kernels take {dkv + dq:.3f} ms together.")
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        ms, plain_ms, lib_ms = measured[name]
        row = {
            "name": name, "route": "cuda", "design": DESIGNS[name], "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": counts[name], "max_abs_err": max(m["max_abs"] for m in errs[name]),
            "rel_l2_err": max(m["rel_l2"] for m in errs[name]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "plain_covers": covers[name][0], "library_covers": covers[name][1],
            "in_step_ms": in_step.get(name),
            "regs": info[name]["regs"], "smem_bytes": info[name]["smem_bytes"],
            "blocks_per_sm": info[name]["blocks_per_sm"],
        }
        rows_out.append(row)
        print(f"{name}: {ms:.3f} ms (bound {row['bound_ms']:.4f} ms by {row['bound_by']}: "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; {row['bound_ms'] / ms:.1%} of bound), "
              f"plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s")
        if watts < 700:
            # A rough restatement: the tensor-core clock, and so the compute
            # peak, scaled by the power limit; memory bandwidth unchanged.
            print(f"  at the card's {watts:.0f} W limit: bound ~{max(t_ops * 700 / watts, t_bytes):.4f} ms")
    return rows_out


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q / 100 * len(xs)) - 1))]


def _kinds(us: dict, per: float) -> dict:
    groups = {}
    for key, t in us.items():
        group = next((g for g, words in PROFILE_GROUPS if any(w in key for w in words)), "other")
        groups[group] = groups.get(group, 0.0) + t / 1e3 / per
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def serve_functions(torch, tt, tg, A, cfg, params, device="cuda"):
    """bf16 function checks: ragged prefill against forward per row, and the
    paged decode chunk against the dense one on the same cache contents."""
    rng = np.random.default_rng(0)
    B, T, q, bs = 4, 512, 8, 16
    lens = rng.integers(64, T + 1, B)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (B, T)), device=device)
    cache = tg.init_cache(cfg, B, cfg.max_seq_len, device=device)
    logits, cache, pos = tg.prefill(params, tokens, cache, cfg, prompt_lens=torch.tensor(lens, device=device))
    failures, worst = [], {}
    with torch.no_grad():
        for b in range(B):
            ref = tt.forward(params, tokens[b : b + 1, : lens[b]], cfg)[0][0, -1]
            m = A.mismatch(logits[b], ref)
            failures += [f"prefill row {b} (length {lens[b]}): {x}" for x in A.over_tolerance(m, cfg.dtype)]
            worst = {k: max(worst.get(k, 0.0), v) for k, v in m.items()}
    print(f"prefill B{B} T{T} prompt_lens {lens.tolist()}: last-row logits against forward, worst "
          + " ".join(f"{k}={v:.2e}" for k, v in worst.items()))
    # The paged copy of the dense cache, through shuffled block tables.
    L, S = cfg.n_layers, cfg.max_seq_len
    n_max = S // bs
    tables = torch.tensor(rng.permutation(np.arange(1, 1 + B * n_max)).reshape(B, n_max), device=device)
    paged = tg.init_paged_cache(cfg, 1 + B * n_max, bs, device=device)
    for name in ("k", "v"):
        for b in range(B):
            paged[name][:, tables[b]] = cache[name][:, b].reshape(L, n_max, bs, cfg.n_kv_heads, cfg.head_dim)
    extra = torch.tensor(rng.integers(0, cfg.vocab_size, (B, q)), device=device)
    dense, _ = tg.decode_chunk(params, extra, cache, pos, cfg)
    got, _ = tg.paged_decode_chunk(params, extra, paged, tables, pos, cfg)
    m = A.mismatch(got, dense)
    failures += [f"paged decode chunk: {x}" for x in A.over_tolerance(m, cfg.dtype)]
    print(f"paged_decode_chunk q{q} (shuffled tables) against decode_chunk: "
          + " ".join(f"{k}={v:.2e}" for k, v in m.items()))
    if failures:
        raise AssertionError("serve functions disagree: " + "; ".join(failures))
    del cache, paged


def serve_engine_exact(torch, tt, tg, LLMEngine, cfg, device="cuda"):
    """f32 at full width, 2 layers, with the traffic run's slots, block size,
    prefill chunk and shared system prefix, and a pool that forces
    preemption: every greedy request's tokens equal generate()'s, through
    prefix-cache hits and preemptions."""
    tr, ex = TRAFFIC, EXACT
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params = tt.init_params(cfg32, seed=0, device=device)
    rng = np.random.default_rng(1)
    system = rng.integers(0, cfg.vocab_size, tr["prefix"]).tolist()
    reqs = [(system + rng.integers(0, cfg.vocab_size, rng.integers(*ex["suffix"])).tolist(),
             int(rng.integers(*ex["new"]))) for _ in range(ex["requests"])]
    eng = LLMEngine(params, cfg32, num_slots=tr["slots"], block_size=tr["block_size"],
                    num_blocks=ex["num_blocks"], prefill_chunk=tr["prefill_chunk"])
    try:
        t0 = time.perf_counter()
        handles = [eng.submit(*reqs[0])]
        # The others arrive once the first has prefilled, so its system-prefix blocks are in the cache.
        while handles[0].t_first is None and time.perf_counter() - t0 < 300:
            time.sleep(0.002)
        handles += [eng.submit(p, max_new_tokens=n) for p, n in reqs[1:]]
        outs = [h.result(timeout=300) for h in handles]
        wall = time.perf_counter() - t0
        stats = eng.stats()
    finally:
        eng.shutdown()
    wrong = []
    for i, ((prompt, n), out) in enumerate(zip(reqs, outs)):
        want = tg.generate(params, torch.tensor([prompt], device=device), cfg32, max_new_tokens=n)[0].tolist()
        if out != want:
            first = next((j for j, (a, b) in enumerate(zip(out, want)) if a != b), min(len(out), len(want)))
            wrong.append(f"request {i}: first differs at token {first} of {n}")
    print(f"engine f32 (2 layers, {tr['slots']} slots, {ex['num_blocks'] - 1} usable blocks of {tr['block_size']}, "
          f"prefill chunk {tr['prefill_chunk']}, a shared {tr['prefix']}-token prefix): {len(reqs)} greedy requests "
          f"in {wall:.1f} s, preemptions {stats['preemptions']}, prefix hits {stats['prefix_hit_blocks']} blocks, "
          f"evictions {stats['evicted_blocks']}; {len(reqs) - len(wrong)} of {len(reqs)} equal to generate()")
    if wrong:
        raise AssertionError("engine tokens differ from generate(): " + "; ".join(wrong))
    if stats["preemptions"] < 1:
        raise AssertionError("the small pool forced no preemption")
    if stats["prefix_hit_blocks"] < 2 * (len(reqs) - 1):
        raise AssertionError(f"the shared prefix was hit for only {stats['prefix_hit_blocks']} blocks")
    del params


def _record_ticks(eng, log, step_log):
    """Wraps the engine's decode tick: appends (ms, active slots) to `log` for
    every tick that ran a step, and the host ms of the step's call (the
    launches, before the logits are copied back) to `step_log`."""
    tick, step = eng._decode_tick, eng._decode_fn

    def timed_step(*args):
        t0 = time.perf_counter()
        out = step(*args)
        step_log.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed():
        n = sum(r is not None and r._sched_state == "decode" for r in eng._slots)
        t0 = time.perf_counter()
        ran = tick()
        if ran and n:
            log.append(((time.perf_counter() - t0) * 1e3, n))
        return ran

    eng._decode_tick, eng._decode_fn = timed, timed_step


def serve_traffic(torch, A, LLMEngine, cfg, params, card, device="cuda"):
    """Closed-loop streams over the engine at the flagship config, then (on
    the card) profiled decode ticks; returns the numbers it prints."""
    tr = TRAFFIC
    rng = np.random.default_rng(2)
    system = rng.integers(0, cfg.vocab_size, tr["prefix"]).tolist()
    specs = []
    for i in range(tr["requests"]):
        suffix = rng.integers(0, cfg.vocab_size, rng.integers(tr["suffix"][0], tr["suffix"][1] + 1)).tolist()
        new = int(np.clip(rng.geometric(1 / tr["mean_new"]), *tr["new"]))
        sampled = i % tr["sampled_every"] == tr["sampled_every"] - 1
        specs.append((system + suffix, new, dict(temperature=0.8, top_k=50, seed=1234) if sampled else {}))
    eng = LLMEngine(params, cfg, num_slots=tr["slots"], block_size=tr["block_size"],
                    max_model_len=cfg.max_seq_len, prefill_chunk=tr["prefill_chunk"])
    ticks, steps = [], []
    _record_ticks(eng, ticks, steps)
    pool_mb = sum(t.numel() * t.element_size() for t in eng._cache.values()) / 1e6
    try:
        eng.submit(system + specs[0][0][-100:], max_new_tokens=16).result(timeout=300)  # warm-up
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before, n_warm, s_warm = eng.stats(), len(ticks), len(steps)
        A.reset_launch_counts()  # the serving path starts here ...
        order, done, errors = itertools.count(), [None] * len(specs), []

        def stream():
            try:
                while (i := next(order)) < len(specs):
                    prompt, new, kw = specs[i]
                    req = eng.submit(prompt, max_new_tokens=new, **kw)
                    done[i] = (req, req.result(timeout=600))
            except BaseException as e:  # noqa: BLE001 — reported after the join
                errors.append(e)

        threads = [threading.Thread(target=stream, name=f"stream{j}") for j in range(tr["streams"])]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        counts = A.launch_counts()  # ... and ends here
        if errors or any(t.is_alive() for t in threads) or None in done:
            raise AssertionError(f"traffic run failed: {errors[:3]}")
        after = eng.stats()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        window = ticks[n_warm:]
        out_tokens = sum(len(toks) for _, toks in done)
        ttft = [(r.t_first - r.t_submit) * 1e3 for r, _ in done]
        tpot = [(r.t_done - r.t_first) * 1e3 / (len(toks) - 1) for r, toks in done if len(toks) > 1]
        tick_ms = sorted(ms for ms, _ in window)
        step_ms = sorted(steps[s_warm:])
        res = {
            "requests": len(done), "output_tokens": out_tokens,
            "prompt_tokens": sum(len(r.prompt) for r, _ in done), "wall_s": wall,
            "output_tokens_per_s": out_tokens / wall,
            "ttft_ms_p50": _percentile(ttft, 50), "ttft_ms_p99": _percentile(ttft, 99),
            "tpot_ms_mean": sum(tpot) / len(tpot),
            "decode_tick_ms_median": tick_ms[len(tick_ms) // 2], "decode_ticks": len(window),
            "decode_launch_ms_median": step_ms[len(step_ms) // 2],
            "decode_slots_mean": sum(n for _, n in window) / len(window),
            "prefix_hit_blocks": after["prefix_hit_blocks"] - before["prefix_hit_blocks"],
            "prefix_miss_blocks": after["prefix_miss_blocks"] - before["prefix_miss_blocks"],
            "preemptions": after["preemptions"] - before["preemptions"],
            "kv_pool_mb": pool_mb, "peak_memory_gib": peak / 2**30, "serve_launches": counts,
        }
        print(f"traffic on {card}: {res['requests']} requests ({res['prompt_tokens']} prompt, {out_tokens} output "
              f"tokens) from {tr['streams']} closed-loop streams over {tr['slots']} slots in {wall:.2f} s: "
              f"{res['output_tokens_per_s']:.1f} output tokens/s; TTFT p50 {res['ttft_ms_p50']:.1f} ms, "
              f"p99 {res['ttft_ms_p99']:.1f} ms (of {len(ttft)}); TPOT {res['tpot_ms_mean']:.2f} ms mean; "
              f"decode tick {res['decode_tick_ms_median']:.2f} ms median of {len(window)} "
              f"({res['decode_slots_mean']:.2f} slots on average), of which {res['decode_launch_ms_median']:.2f} ms "
              f"median issuing the step's launches on the host")
        print(f"traffic: prefix hits {res['prefix_hit_blocks']} blocks, misses {res['prefix_miss_blocks']}; "
              f"preemptions {res['preemptions']}; KV pool {pool_mb:.1f} MB ({eng.num_blocks} blocks); "
              f"max_memory_allocated {res['peak_memory_gib']:.2f} GiB; flash kernel launches {counts}")
        if any(counts.values()):
            raise AssertionError(f"the serving path launched flash kernels: {counts}")
    finally:
        eng.shutdown()
    if device == "cuda":
        res.update(_profile_decode(torch, LLMEngine, cfg, params, specs))
    return res, done


def _profile_decode(torch, LLMEngine, cfg, params, specs):
    """Decode ticks with every slot busy: PROFILED_TICKS timed on the host
    clock, then as many under torch.profiler for the device ms a tick by
    kind; the device-busy share is the second over the first (the profiler's
    own cost on the host would inflate a profiled tick). The profiler records
    the launches of the thread that started it, so the ticks run on this
    thread: an engine of the traffic run's shape whose own scheduler thread
    is stopped, driven as the engine's white-box tests drive it (the same
    tick code, without the thread's wake-ups)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    tr = TRAFFIC
    eng = LLMEngine(params, cfg, num_slots=tr["slots"], block_size=tr["block_size"],
                    max_model_len=cfg.max_seq_len, prefill_chunk=tr["prefill_chunk"])
    eng.shutdown()
    eng._crashed = None  # re-open submits; this thread runs the scheduler
    for i in range(eng.num_slots):
        eng.submit(specs[i][0][:128], max_new_tokens=256)
    for _ in range(eng.num_slots * 8):  # admit and prefill every prompt
        if not eng._waiting and all(r is not None and r._sched_state == "decode" for r in eng._slots):
            break
        eng._admit()
        eng._prefill_tick()
    else:
        raise AssertionError("the profiled engine did not reach a full decode batch")
    for _ in range(3):  # warm-up
        eng._decode_tick()
    torch.cuda.synchronize()
    n = PROFILED_TICKS
    t0 = time.perf_counter()
    for _ in range(n):
        eng._decode_tick()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) * 1e3 / n
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng._decode_tick()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / n
    del eng
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    us = {e.key: e.self_device_time_total for e in events}
    device_ms = sum(us.values()) / 1e3
    if device_ms <= 0:
        print("decode ticks: device-busy share not measured (the profiler recorded no device time)")
        return {"device_busy_share": None}
    kinds, launches = _kinds(us, n), sum(e.count for e in events) / n
    print(f"decode ticks, {tr['slots']} slots busy, driven on this thread: {tick_ms:.2f} ms a tick over {n} "
          f"(under the profiler {profiled_ms:.2f}); {device_ms / n:.2f} ms of kernels and {launches:.0f} device "
          f"operations a tick: device busy {device_ms / n / tick_ms:.1%} of a tick; by kind, ms a tick: "
          + ", ".join(f"{g} {ms:.3f}" for g, ms in kinds.items()))
    print("busiest:")
    for key, t in sorted(us.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {t / 1e3 / n:8.4f} ms a tick  {key[:110]}")
    return {"device_busy_share": device_ms / n / tick_ms, "profiled_thread_tick_ms": tick_ms,
            "tick_ms_under_profiler": profiled_ms, "device_ops_per_tick": launches,
            "device_ms_per_tick": device_ms / n, "device_ms_per_tick_by_kind": kinds}


def serve_check(torch, tt, cfg, params, done, device="cuda"):
    """Teacher-forces every greedy request's prompt + emitted tokens through
    forward: each emitted token's logit must lie within SERVE_LOGIT_BAR of
    its row's maximum."""
    worst, agree, total, over = 0.0, 0, 0, []
    with torch.no_grad():
        for req, toks in done:
            if req.temperature > 0:
                continue
            P = len(req.prompt)
            seq = torch.tensor([req.prompt + toks[:-1]], device=device)
            logits = tt.forward(params, seq, cfg)[0][0, P - 1 :]  # row j predicts toks[j]
            emitted = torch.tensor(toks, device=device)
            short = logits.max(-1).values - logits[torch.arange(len(toks), device=device), emitted]
            worst = max(worst, short.max().item())
            agree += (logits.argmax(-1) == emitted).sum().item()
            total += len(toks)
            if short.max().item() > SERVE_LOGIT_BAR:
                over.append(f"{req.id}: {short.max().item():.3f} at token {short.argmax().item()}")
            logit_std = logits.std().item()
    print(f"teacher-forced check: {total} greedy tokens, {agree / total:.2%} are forward's argmax; "
          f"largest shortfall from the row maximum {worst:.4f} (bar {SERVE_LOGIT_BAR}; logits' std ~{logit_std:.2f})")
    if over:
        raise AssertionError("emitted tokens beyond the bar: " + "; ".join(over))
    return {"greedy_tokens": total, "argmax_share": agree / total, "max_shortfall": worst}


def serve_phase(torch, card):
    _phase("serve")
    from ray_tpu_torch.models import generate as tg
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = tt.TransformerConfig(**SERVE_CFG, dtype=torch.bfloat16, param_dtype=torch.float32, remat=False)
    params = tt.init_params(cfg, seed=0)
    serve_functions(torch, tt, tg, A, cfg, params)
    serve_engine_exact(torch, tt, tg, LLMEngine, cfg)
    res, done = serve_traffic(torch, A, LLMEngine, cfg, params, card)
    res.update(serve_check(torch, tt, cfg, params, done))
    print("serve: " + json.dumps(res))
    del params
    torch.cuda.empty_cache()
    return res


def _alive(pid: int) -> bool:
    """True while `pid` runs (a zombie counts as gone)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def trainer_phase(torch, card, main_first_loss, main_step_ms):
    """The main path's train step in a GPU worker actor, through the port's
    init() and TorchTrainer; returns the worker's launch counts."""
    _phase("trainer")
    import ray_tpu_torch as rt
    from ray_tpu_torch.air.config import RunConfig, ScalingConfig
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.train.flagship_loop import train_loop
    from ray_tpu_torch.train.torch import TorchTrainer

    config = dict(
        model=dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8, d_ff=2816,
                   max_seq_len=1024, remat=False, fused_loss=False, scan_unroll=8),
        dtype="bfloat16", batch=MAIN["B"], seq=MAIN["T"], param_seed=0, batch_seed=1, **TRAINER,
    )
    storage = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    A.reset_launch_counts()
    t0 = time.time()
    rt.init(num_cpus=4, num_gpus=1)
    try:
        print(f"init: {time.time() - t0:.2f} s; cluster resources {rt.cluster_resources()}")
        result = TorchTrainer(
            train_loop, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(storage_path=storage),
        ).fit()
        # The raylet's workers and, whether or not it is still listed, the
        # process the loop reported it ran in.
        pids = sorted({w.pid for w in rt._global_node.raylet.workers.values() if w.pid} | {result.metrics["pid"]})
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    deadline = time.monotonic() + 30
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = [p for p in pids if _alive(p)]
    driver_counts = A.launch_counts()
    m = result.metrics
    steps, counts, L = m["steps"], m["launches"], config["model"]["n_layers"]
    tok = MAIN["B"] * MAIN["T"]
    raw_ms = tok / m["tokens_per_sec_raw"] * 1e3
    n_prof = TRAINER["profile_steps"]
    device_ms = sum(m["device_us"].values()) / 1e3 / n_prof
    flash_ms = {n: sum(t for key, t in m["device_us"].items() if n in key) / 1e3 / n_prof for n in KERNELS}
    rel = abs(m["first_loss"] - main_first_loss) / abs(main_first_loss)
    print(f"worker device: {m['device_name']} (driver's card: {torch.cuda.get_device_name(0)}); the loop ran "
          f"in pid {m['pid']}; worker pids {pids}, {len(left)} left after shutdown()")
    print(f"worker launches over {steps} steps: {counts} (expected {steps * L} each); "
          f"driver launches meanwhile: {driver_counts}")
    print(f"first loss: worker {m['first_loss']:.6f}, main path {main_first_loss:.6f} "
          f"(relative difference {rel:.2e}, bar {TRAINER_LOSS_RTOL})")
    print(f"trainer on {card}: framework {m['tokens_per_sec_framework']:.0f} tokens/s, raw "
          f"{m['tokens_per_sec_raw']:.0f} tokens/s, ratio {m['ratio']:.4f} (raw time / framework time; "
          f"{TRAINER['rounds']} ABBA rounds of {TRAINER['chunk']}-step chunks); worker step "
          f"{tok / m['tokens_per_sec_raw'] * 1e3:.1f} ms raw, {tok / m['tokens_per_sec_framework'] * 1e3:.1f} ms "
          f"framework (main path's median {main_step_ms:.1f} ms); worker max_memory_allocated "
          f"{m['peak_memory_bytes'] / 2**30:.2f} GiB; init() to first report {m['first_report_time'] - t0:.2f} s "
          f"(init() to the loop's start in the worker {m['start_time'] - t0:.2f} s, then set-up and the first "
          f"step {m['first_report_time'] - m['start_time']:.2f} s)")
    if device_ms > 0:
        print(f"worker, {n_prof} steps under torch.profiler: device time {device_ms:.1f} ms per step, "
              f"device busy {device_ms / raw_ms:.1%} of the raw step; by kind: "
              + ", ".join(f"{g} {ms:.1f} ms" for g, ms in _kinds(m["device_us"], n_prof).items())
              + "; flash kernels, ms per step: " + ", ".join(f"{n} {ms:.3f}" for n, ms in flash_ms.items()))
    else:
        print("worker device time: not measured (the profiler recorded no device time)")
    failures = []
    if m["device_name"] != torch.cuda.get_device_name(0):
        failures.append(f"the worker ran on {m['device_name']!r}")
    if counts != {n: steps * L for n in KERNELS}:
        failures.append(f"the worker launched {counts}, not {L} per step")
    if not rel <= TRAINER_LOSS_RTOL:
        failures.append(f"first loss {m['first_loss']} is not the main path's {main_first_loss}")
    if m["pid"] == os.getpid():
        failures.append("the loop ran in the driver's process, not in a worker")
    if left:
        failures.append(f"worker processes {left} outlived shutdown()")
    if any(driver_counts.values()):
        failures.append(f"the driver launched kernels during the trainer run: {driver_counts}")
    if failures:
        raise AssertionError("trainer phase: " + "; ".join(failures))
    print("trainer: " + json.dumps({
        "device_name": m["device_name"], "steps": steps, "launches": counts, "first_loss": m["first_loss"],
        "main_first_loss": main_first_loss, "tokens_per_sec_framework": m["tokens_per_sec_framework"],
        "tokens_per_sec_raw": m["tokens_per_sec_raw"], "ratio": m["ratio"],
        "peak_memory_gib": m["peak_memory_bytes"] / 2**30,
        "init_to_first_report_s": m["first_report_time"] - t0, "init_to_loop_start_s": m["start_time"] - t0,
        "worker_device_ms_per_step": device_ms or None,
        "worker_device_busy_share": device_ms / raw_ms if device_ms else None,
    }))
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    smi, card = device_phase(torch)
    info = build_phase()
    errs = kernels_phase(torch)
    counts, in_step, first_loss, step_ms = main_path_phase(torch, smi)
    kernels = timings_phase(torch, smi, counts, errs, info, in_step)
    serve_phase(torch, smi)
    worker_counts = trainer_phase(torch, smi, first_loss, step_ms)
    for row in kernels:
        row["worker_launches"] = worker_counts[row["name"]]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
