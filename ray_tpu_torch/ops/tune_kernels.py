"""Time design variants of the flash-attention kernels on one card.

    python -m ray_tpu_torch.ops.tune_kernels [--f32] [--against CSRC]

Needs one CUDA card and nvcc. Each variant is a few text edits of a copy of
``ops/csrc`` (written under ``ray_tpu_torch/_build/variants/``, never into
``csrc``); the copies build in parallel. ``--against CSRC`` adds a build of
another checkout's ``ops/csrc`` (an earlier commit's, unpacked with ``git
archive``) under the name "against". Every build's kernels are held against
the plain versions (``attention.MATCH_TOL``) and timed at each shape in
rounds that take the builds in turn, so that they are compared within one
call on one card:

- by default the bf16 variants (``VARIANTS``): forward, dK/dV and dQ at the
  main path's shapes (bf16, B 12, T 1024, H 8, D 128, causal), with CUDA
  events around 30 calls;
- with ``--f32`` the f32 variants (``F32_VARIANTS``): forward, dK/dV and dQ
  at the main path's shapes in f32 (events around 30 calls) and at the Decision
  Transformer's (f32, B 64, T 60, H 2, D 32, causal), where a kernel runs
  for less time than its wrapper takes on the host: there each time is the
  device's, from a CUDA graph of 50 calls replayed.

Prints each build's registers, shared memory and blocks per SM and, per
round, build and shape, each kernel's ms and its worst readings against the
plain version; then one JSON line. Exits 1 if a variant disagrees with the
plain versions.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
from pathlib import Path
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

F32_VARIANTS = {
    "as built": ("ops/csrc unchanged", []),
    "f32 fwd S fresh": (
        "the forward's S summed as its P V, in fresh fragments added by f32 adds, in place of the tensor cores' "
        "accumulator",
        [("flash_fwd.cu", "mm_abt_tf32<D, BK, false>(s, Qs", "mm_abt_tf32<D, BK, true>(s, Qs")]),
    "f32 dq S and dP in the mma": (
        "dQ's S and dP summed in the tensor cores' accumulator, as the forward's S, in place of fresh fragments",
        [("flash_bwd.cu", "mm_abt_tf32<D, BK, true>(s, Qs", "mm_abt_tf32<D, BK, false>(s, Qs"),
         ("flash_bwd.cu", "mm_abt_tf32<D, BK, true>(dp, dOs", "mm_abt_tf32<D, BK, false>(dp, dOs")]),
    "f32 fwd 16-key stages": (
        "f32 forward with K/V stages of 16 keys at D 128 in place of 32",
        [("flash_fwd.cu", "constexpr int kFwdF32BK = D == 128 ? 32 : 64;",
          "constexpr int kFwdF32BK = D == 128 ? 16 : 64;")]),
    "f32 dkv S^T and dP^T in the mma": (
        "dK/dV's S^T and dP^T summed in the tensor cores' accumulator, as the forward's S, in place of fresh "
        "fragments",
        [("flash_bwd.cu", "mm_abt_tf32<D, BQ, true>(s, Ks", "mm_abt_tf32<D, BQ, false>(s, Ks"),
         ("flash_bwd.cu", "mm_abt_tf32<D, BQ, true>(dp, Vs", "mm_abt_tf32<D, BQ, false>(dp, Vs")]),
    "f32 dkv 32-query stages": (
        "f32 dK/dV with query stages of 32 rows at D 128 (one block per SM: K, V and the ring take 128 KB) in "
        "place of 16",
        [("flash_bwd.cu", "constexpr int kDkvF32BQ = D == 32 ? 64 : D == 64 ? 32 : 16;",
          "constexpr int kDkvF32BQ = D == 32 ? 64 : D == 64 ? 32 : 32;")]),
    "f32 dq 32-key stages": (
        "f32 dQ with K/V stages of 32 keys at D 128 (one block per SM) in place of 16",
        [("flash_bwd.cu", "constexpr int kDqF32BK = D == 128 ? 16 : 64;",
          "constexpr int kDqF32BK = D == 128 ? 32 : 64;")]),
}
SHAPES = {  # mode: {shape: (B, T, H, D)}
    "bf16": {"main": (12, 1024, 8, 128)},
    "f32": {"main": (12, 1024, 8, 128), "dt": (64, 60, 2, 32)},
}
KERNELS = {"flash_fwd": "forward", "flash_bwd_dkv": "dK/dV", "flash_bwd_dq": "dQ"}
ROUNDS, ITERS, GRAPH_CALLS, GRAPH_REPLAYS = 2, 30, 50, 20


def _time_ms(fn) -> float:
    """ms a call, with events around ITERS calls (host code included)."""
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def _graph_ms(fn) -> float:
    """The device's ms a call: GRAPH_CALLS calls captured in one CUDA graph
    (warmed up and captured on a side stream), replayed GRAPH_REPLAYS times
    between events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / GRAPH_REPLAYS / GRAPH_CALLS


def _case(dtype, B, T, H, D):
    """The kernels' launches on seeded causal inputs and the plain results:
    ({kernel: (launch, names of its outputs)}, {output: plain result})."""
    g = torch.Generator(device="cuda").manual_seed(100)
    q, k, v, dout = (torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype) for _ in range(4))
    scale = D**-0.5
    out_ref, lse_ref = A._plain_flash_fwd(q, k, v, True, scale, 0)
    dq_ref, dk_ref, dv_ref = A._plain_flash_bwd(q, k, v, out_ref, lse_ref, dout, True, scale, 0)
    delta = (dout.float() * out_ref.float()).sum(-1).transpose(1, 2).contiguous()
    calls = {
        "flash_fwd": (lambda: A.flash_fwd_cuda(q, k, v, True, scale, 0, save_lse=True), ("out", "lse")),
        "flash_bwd_dkv": (lambda: A.flash_bwd_dkv_cuda(q, k, v, dout, lse_ref, delta, True, scale, 0), ("dk", "dv")),
        "flash_bwd_dq": (lambda: (A.flash_bwd_dq_cuda(q, k, v, dout, lse_ref, delta, True, scale, 0),), ("dq",)),
    }
    return calls, {"out": out_ref, "lse": lse_ref, "dq": dq_ref, "dk": dk_ref, "dv": dv_ref}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Time design variants of the flash-attention kernels on one card.")
    parser.add_argument("--f32", action="store_true", help="the f32 variants, at the main path's shape and DT's")
    parser.add_argument("--against", type=Path, help="another checkout's ops/csrc, built and timed as 'against'")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_kernels: no CUDA device", file=sys.stderr)
        return 1
    mode = "f32" if args.f32 else "bf16"
    dtype, variants = (torch.float32, F32_VARIANTS) if args.f32 else (torch.bfloat16, VARIANTS)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products in full f32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    copies = {name: _build.edited_copy(_build.BUILD_DIR / "variants" / f"v{i}" / "csrc", edits)
              for i, (name, (_, edits)) in enumerate(variants.items())}
    dirs = {name: csrc.parent for name, csrc in copies.items()}
    descriptions = {name: desc for name, (desc, _) in variants.items()}
    if args.against:
        copies["against"], dirs["against"] = args.against.resolve(), _build.BUILD_DIR / "variants" / "against"
        descriptions["against"] = f"the kernels of {args.against}"
    with concurrent.futures.ThreadPoolExecutor(len(copies)) as pool:
        futures = {name: pool.submit(_build.build_and_load, csrc, dirs[name]) for name, csrc in copies.items()}
        builds = {name: f.result() for name, f in futures.items()}
    D_main = SHAPES[mode]["main"][3]
    # Another checkout's library may report its resources by another signature.
    info = {name: {kern: k.info(kern, D_main, bf16=not args.f32) for kern in KERNELS}
            for name, k in builds.items() if name != "against"}
    for name in builds:
        print(f"{name:>22}: {descriptions[name]}" + ("" if name not in info else f"\n{'':>24}" + "; ".join(
            f"{kern} {x['regs']} registers, {x['smem_bytes']} B shared, {x['blocks_per_sm']} block(s) of "
            f"{x['threads'] // 32} warps/SM, {x['local_bytes']} B local" for kern, x in info[name].items())))

    times = {name: {shape: {kern: [] for kern in KERNELS} for shape in SHAPES[mode]} for name in builds}
    readings = {name: {shape: {} for shape in SHAPES[mode]} for name in builds}
    wrong = []
    for shape, dims in SHAPES[mode].items():
        calls, want = _case(dtype, *dims)
        timer = _graph_ms if shape == "dt" else _time_ms
        for rnd in range(ROUNDS):
            for name, kernels in builds.items():
                over, line = [], []
                with mock.patch.object(_build, "load_kernels", lambda: kernels):  # the wrappers launch from this build
                    for kern in KERNELS:
                        launch, outs = calls[kern]
                        ms = [A.mismatch(got, want[o]) for o, got in zip(outs, launch())]
                        worst = {key: max(m[key] for m in ms) for key in ("rel_l2", "elem")}
                        readings[name][shape][kern] = worst
                        over += [f"{kern}: {x}" for m in ms for x in A.over_tolerance(m, dtype)]
                        times[name][shape][kern].append(timer(launch))
                        line.append(f"{KERNELS[kern]} {times[name][shape][kern][-1]:.4f} ms "
                                    f"(rel_l2 {worst['rel_l2']:.1e}, elem {worst['elem']:.1e})")
                if over and rnd == 0:
                    wrong.append(f"{name}/{shape}: {over}")
                print(f"round {rnd} {shape:>4} {name:>22}: " + ", ".join(line) + ("  OVER THE BAR" if over else ""),
                      flush=True)
        del calls, want
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "dtype": mode, "causal": True, "shapes": SHAPES[mode],
                      "variants": {n: {"edits": descriptions[n], "ms": times[n], "readings": readings[n],
                                       "info": info.get(n)} for n in builds}}))
    if wrong:
        print("tune_kernels: variants disagree with the plain versions: " + "; ".join(wrong), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
