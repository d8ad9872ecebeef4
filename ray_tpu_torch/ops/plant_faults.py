"""Plant known faults in copies of the flash-attention kernels and show that
the kernel-vs-plain check (``attention.mismatch`` against ``MATCH_TOL``)
catches each one.

    python -m ray_tpu_torch.ops.plant_faults

Needs one CUDA card and nvcc. Each fault is a one-line edit of a copy of
``ops/csrc``; the copies are written under ``ray_tpu_torch/_build/faults/``
(never into ``csrc``) and built in parallel. Each copy's three kernels are
held against the plain versions at the main path's shapes (bf16, B 12,
T 1024, H 8, D 128, causal) or, for the window fault, with a window of 256.
The sound kernels go first, so their readings show how far below the bars
they sit.

Prints a line per build, case and kernel, then one JSON line of every
reading. Exits 1 if the check passes a kernel that a fault breaks, or fails
one that it leaves intact.
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

# name: (file, sound text, faulty text, case, kernels it breaks). Each sound
# text occurs once in its file (tests/test_torch_plant_faults.py).
FAULTS = {
    # The query tiles from row 512 on skip their second key tile: 64 of their
    # ~600-1000 keys.
    "fwd_skip_key_tile": (
        "flash_fwd.cu",
        "int mode = tile_mode(qp_lo, qp_lo + 15, k0, k0 + BK - 1, k0 + BK > Tk, causal, window);\n",
        "int mode = tile_mode(qp_lo, qp_lo + 15, k0, k0 + BK - 1, k0 + BK > Tk, causal, window);\n"
        "    if (kt == kt_begin + 1 && q0 >= 512) mode = kSkip;\n",
        "main", ("flash_fwd",)),
    # The register accumulator is not rescaled when a row's max rises.
    "fwd_no_rescale": (
        "flash_fwd.cu", "o[n][e] *= corr[e >> 1];", "o[n][e] *= 1.f;",
        "main", ("flash_fwd",)),
    # The query tiles from row 512 on skip their second key tile in dQ.
    "dq_skip_key_tile": (
        "flash_bwd.cu",
        "k0 + BK - 1, k0 + BK > Tk, causal, window);\n",
        "k0 + BK - 1, k0 + BK > Tk, causal, window);\n    if (kt == kt_begin + 1 && q0 >= 512) mode = kSkip;\n",
        "main", ("flash_bwd_dq",)),
    # Every warp of each key tile skips the second query tile that sees it.
    "dkv_skip_query_tile": (
        "flash_bwd.cu",
        "kr_last, ragged, causal, window);\n",
        "kr_last, ragged, causal, window);\n    if (qt == qt_begin + 1) mode = kSkip;\n",
        "main", ("flash_bwd_dkv",)),
    # Each row sees one key more than its window: (i - window, i] becomes [i - window, i].
    "window_off_by_one": (
        "flash_common.cuh", "qpos - kpos < window", "qpos - kpos <= window",
        "window256", ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")),
}
CASES = {  # name: (B, T, H, D, causal, window)
    "main": (12, 1024, 8, 128, True, 0),
    "window256": (2, 1024, 8, 128, True, 256),
}
OUTPUTS = {"flash_fwd": ("out", "lse"), "flash_bwd_dkv": ("dk", "dv"), "flash_bwd_dq": ("dq",)}


def _case(name: str, seed: int):
    """Inputs and plain results of one case."""
    B, T, H, D, causal, window = CASES[name]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    scale = D**-0.5
    out, lse = A._plain_flash_fwd(q, k, v, causal, scale, window)
    dq, dk, dv = A._plain_flash_bwd(q, k, v, out, lse, dout, causal, scale, window)
    return (q, k, v, dout, causal, scale, window), {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def _readings(kernels, args, want) -> dict[str, dict[str, dict[str, float]]]:
    """{kernel: {output: mismatch readings}} of one library on one case."""
    q, k, v, dout, causal, scale, window = args
    with mock.patch.object(_build, "load_kernels", lambda: kernels):  # the wrappers launch from this library
        out, lse = A.flash_fwd_cuda(q, k, v, causal, scale, window, save_lse=True)
        dq, dk, dv = A.flash_bwd_cuda(q, k, v, want["out"], want["lse"], dout, causal, scale, window)
    got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    return {kern: {o: A.mismatch(got[o], want[o]) for o in outs} for kern, outs in OUTPUTS.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("plant_faults: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' products in full f32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"bars (bf16): {A.MATCH_TOL[torch.bfloat16]}")

    builds = {"sound": _build.load_kernels()}
    copies = {name: _build.edited_copy(_build.BUILD_DIR / "faults" / name / "csrc", [spec[:3]])
              for name, spec in FAULTS.items()}
    with concurrent.futures.ThreadPoolExecutor(len(copies)) as pool:
        futures = {name: pool.submit(_build.build_and_load, csrc, csrc.parent) for name, csrc in copies.items()}
        builds.update((name, f.result()) for name, f in futures.items())

    report, wrong = [], []
    for i, case in enumerate(CASES):
        args, want = _case(case, seed=i)
        for name, kernels in builds.items():
            if name != "sound" and FAULTS[name][3] != case:
                continue
            broken = FAULTS[name][4] if name != "sound" else ()
            for kern, outs in _readings(kernels, args, want).items():
                over = [f"{o}: {', '.join(x)}" for o, m in outs.items() if (x := A.over_tolerance(m, torch.bfloat16))]
                caught = bool(over)
                if caught != (kern in broken):
                    wrong.append(f"{name}/{case}/{kern}: {'caught' if caught else 'passed'}")
                print(f"{name:>20} {case:>9} {kern:>13} {'CAUGHT' if caught else 'passes':>6}  "
                      + "  ".join(f"{o} rel_l2={m['rel_l2']:.2e} elem={m['elem']:.2e} max_abs={m['max_abs']:.2e}"
                                  for o, m in outs.items()), flush=True)
                report.append({"build": name, "case": case, "kernel": kern, "caught": caught, "readings": outs})
        del args, want
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "bars": A.MATCH_TOL[torch.bfloat16], "results": report}))
    if wrong:
        print("plant_faults: the check misjudged " + "; ".join(wrong), file=sys.stderr)
        return 1
    print(f"every planted fault caught ({len(FAULTS)}), the sound kernels and untouched kernels pass")
    return 0


if __name__ == "__main__":
    sys.exit(main())
