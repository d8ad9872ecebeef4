"""Time design variants of the bf16 forward, dK/dV and dQ kernels on one card.

    python -m ray_tpu_torch.ops.tune_kernels

Needs one CUDA card and nvcc. Each variant is a few text edits of a copy of
``ops/csrc`` (written under ``ray_tpu_torch/_build/variants/``, never into
``csrc``); the copies build in parallel. Every build's three kernels are
held against the plain versions (``attention.MATCH_TOL``) and timed with
CUDA events at the main path's shapes (bf16, B 12, T 1024, H 8, D 128,
causal), in two rounds that take the builds in turn, so that they are
compared within one call on one card.

Prints each build's registers, shared memory and blocks per SM, a line per
round and build, then one JSON line. Exits 1 if a variant disagrees with the
plain versions.
"""

from __future__ import annotations

import concurrent.futures
import json
import subprocess
import sys
from unittest import mock

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as A

# name: (what it changes against the sources, [(file, sound text, new text), ...])
VARIANTS = {
    "as built": ("ops/csrc unchanged", []),
    "fwd no 2-block bound": (
        "forward without __launch_bounds__' two blocks per SM, which caps nothing at 128 threads but changes "
        "how ptxas allocates registers",
        [("flash_fwd.cu", "__launch_bounds__(kFwdThreads, 2)", "__launch_bounds__(kFwdThreads)")]),
    "fwd 128-row tiles": (
        "forward with 128-row query tiles of 8 warps, registers capped at 128 so that two blocks fit an SM",
        [("flash_fwd.cu", "constexpr int kFwdBQ = 64;", "constexpr int kFwdBQ = 128;")]),
    "fwd 128-row tiles, 1 block/SM": (
        "forward with 128-row query tiles of 8 warps and no register cap (one block per SM)",
        [("flash_fwd.cu", "constexpr int kFwdBQ = 64;", "constexpr int kFwdBQ = 128;"),
         ("flash_fwd.cu", "__launch_bounds__(kFwdThreads, 2)", "__launch_bounds__(kFwdThreads)")]),
    "dkv 128-key tiles": (
        "dK/dV with 128-key blocks of 8 warps (one block per SM)",
        [("flash_bwd.cu", "constexpr int kDkvBK = 64;", "constexpr int kDkvBK = 128;")]),
    "dq no 2-block bound": (
        "dQ without __launch_bounds__' two blocks per SM",
        [("flash_bwd.cu", "__launch_bounds__(kDqThreads, 2)", "__launch_bounds__(kDqThreads)")]),
    "dq 128-row tiles": (
        "dQ with 128-row query tiles of 8 warps, so each K/V tile is read by twice the rows (one block per SM: "
        "Q, dO and the K/V ring take 128 KB)",
        [("flash_bwd.cu", "constexpr int kDqBQ = 64;", "constexpr int kDqBQ = 128;"),
         ("flash_bwd.cu", "__launch_bounds__(kDqThreads, 2)", "__launch_bounds__(kDqThreads)")]),
}
KERNELS = {"flash_fwd": "forward", "flash_bwd_dkv": "dK/dV", "flash_bwd_dq": "dQ"}
B, T, H, D = 12, 1024, 8, 128
ROUNDS, ITERS = 2, 30


def _time_ms(fn) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_kernels: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    copies = {name: _build.edited_copy(_build.BUILD_DIR / "variants" / f"v{i}" / "csrc", edits)
              for i, (name, (_, edits)) in enumerate(VARIANTS.items())}
    with concurrent.futures.ThreadPoolExecutor(len(copies)) as pool:
        futures = {name: pool.submit(_build.build_and_load, csrc, csrc.parent) for name, csrc in copies.items()}
        builds = {name: f.result() for name, f in futures.items()}
    info = {name: {kern: k.info(kern, D) for kern in KERNELS} for name, k in builds.items()}
    for name, i in info.items():
        print(f"{name:>18}: {VARIANTS[name][0]}\n{'':>20}" + "; ".join(
            f"{kern} {x['regs']} registers, {x['smem_bytes']} B shared, {x['blocks_per_sm']} block(s) of "
            f"{x['threads'] // 32} warps/SM, {x['local_bytes']} B local" for kern, x in i.items()))

    g = torch.Generator(device="cuda").manual_seed(100)
    q, k, v, dout = (torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    scale = D**-0.5
    out_ref, lse_ref = A._plain_flash_fwd(q, k, v, True, scale, 0)
    dq_ref, dk_ref, dv_ref = A._plain_flash_bwd(q, k, v, out_ref, lse_ref, dout, True, scale, 0)
    delta = (dout.float() * out_ref.float()).sum(-1).transpose(1, 2).contiguous()
    calls = {  # kernel: (launch, names of its outputs)
        "flash_fwd": (lambda: A.flash_fwd_cuda(q, k, v, True, scale, 0, save_lse=True), ("out", "lse")),
        "flash_bwd_dkv": (lambda: A.flash_bwd_dkv_cuda(q, k, v, dout, lse_ref, delta, True, scale, 0), ("dk", "dv")),
        "flash_bwd_dq": (lambda: (A.flash_bwd_dq_cuda(q, k, v, dout, lse_ref, delta, True, scale, 0),), ("dq",)),
    }
    want = {"out": out_ref, "lse": lse_ref, "dq": dq_ref, "dk": dk_ref, "dv": dv_ref}
    times, wrong = {name: {kern: [] for kern in KERNELS} for name in builds}, []
    for rnd in range(ROUNDS):
        for name, kernels in builds.items():
            over = []
            with mock.patch.object(_build, "load_kernels", lambda: kernels):  # the wrappers launch from this build
                for kern, (launch, outs) in calls.items():
                    for o, got in zip(outs, launch()):
                        if x := A.over_tolerance(A.mismatch(got, want[o]), q.dtype):
                            over.append(f"{o}: {x}")
                    times[name][kern].append(_time_ms(launch))
            if over and rnd == 0:
                wrong.append(f"{name}: {over}")
            print(f"round {rnd} {name:>18}: " + ", ".join(f"{label} {times[name][kern][-1]:.4f} ms"
                                                          for kern, label in KERNELS.items())
                  + ("  DISAGREES " + str(over) if over else ""), flush=True)
    print(json.dumps({"device": smi, "shapes": dict(B=B, T=T, H=H, D=D, causal=True, dtype="bf16"),
                      "variants": {n: {"edits": VARIANTS[n][0], "ms": times[n], "info": info[n]} for n in builds}}))
    if wrong:
        print("tune_kernels: variants disagree with the plain versions: " + "; ".join(wrong), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
