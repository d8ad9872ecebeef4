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

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Without a card it exits 1 and prints neither.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

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
    groups = {}
    for key, t in us.items():
        group = next((g for g, words in PROFILE_GROUPS if any(w in key for w in words)), "other")
        groups[group] = groups.get(group, 0.0) + t / 1e3 / steps
    print(f"in-step device time: {total_ms:.1f} ms per step; by kind: "
          + ", ".join(f"{g} {ms:.1f} ms" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
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
    _, ms, counts, peak, prof = _train(torch, tt, A, cfg, STEPS, B, "bench config", profiled=PROFILED)
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
    return counts, ({n: t / L for n, t in prof[1].items()} if prof else {})


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    smi, card = device_phase(torch)
    info = build_phase()
    errs = kernels_phase(torch)
    counts, in_step = main_path_phase(torch, smi)
    kernels = timings_phase(torch, smi, counts, errs, info, in_step)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
