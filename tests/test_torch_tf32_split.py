"""The premise of the f32 kernels' 3xTF32 products, on the CPU.

The f32 forward and dQ kernels (``ops/csrc/flash_tf32.cuh``) run every
product on the tensor cores, whose operands are TF32 (10 mantissa bits). Each
f32 operand x is split into x_hi = tf32(x) and x_lo = tf32(x - x_hi), and a
product a b is taken as a_hi b_lo + a_lo b_hi + a_hi b_hi. Here the same
split runs in torch, with TF32 rounding emulated on the bits, through
attention's products (S = Q K^T, O = P V; dP = dO V^T, dQ = dS K): with the
three products the forward and dQ lie within ``MATCH_TOL[float32]`` of the
plain versions, with one TF32 product they do not. So the f32 bar can tell
the kernels' design from a single TF32 product, at the Decision
Transformer's shape and at D 128 over 1024 keys, where the sums are longest.
A model of the tensor cores' accumulator, which rounds its sums toward zero,
shows where the kernels may sum there and where they sum apart.
"""

import math

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as A

SHAPES = pytest.mark.parametrize("B,T,H,D", [(64, 60, 2, 32), (1, 1024, 1, 128)], ids=["dt", "d128-t1024"])


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, keeping 10 of the 23 mantissa bits (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(eq, a, b, products):
    """einsum(eq, a, b) from TF32 operands: three products (3xTF32, the two
    small ones first) or one."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    main = torch.einsum(eq, a_hi, b_hi)
    if products == 1:
        return main
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)) + main


def _split_attention(q, k, v, dout, scale, products):
    """Causal attention's out, lse and dq with every product in TF32 form."""
    T = q.shape[1]
    s = _product("bqhd,bkhd->bhqk", q, k, products) * scale
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = _product("bhqk,bkhd->bqhd", p, v, products)
    dp = _product("bqhd,bkhd->bhqk", dout, v, products)
    delta = (dout * out).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None]) * scale
    dq = _product("bhqk,bkhd->bqhd", ds, k, products)
    return {"out": out, "lse": lse, "dq": dq}


def _readings(B, T, H, D, products):
    rng = np.random.default_rng(17)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((B, T, H, D), dtype=np.float32)) for _ in range(4))
    scale = D**-0.5
    out, lse = A._plain_flash_fwd(q, k, v, True, scale, 0)
    dq, _, _ = A._plain_flash_bwd(q, k, v, out, lse, dout, True, scale, 0)
    got = _split_attention(q, k, v, dout, scale, products)
    return {name: A.mismatch(got[name], want) for name, want in (("out", out), ("lse", lse), ("dq", dq))}


def test_tf32_rounding_is_to_nearest_ties_away():
    one_ulp, half_ulp = 2.0**-10, 2.0**-11  # TF32's step at 1, and half of it
    x = torch.tensor([1 + half_ulp, -(1 + half_ulp), 1 + half_ulp - 2.0**-23, 1 + 3 * half_ulp, 3.0, 0.0])
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp, 3.0, 0.0])
    assert torch.equal(_tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000, dtype=np.float32))
    hi = _tf32(y)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((y - hi).abs() <= hi.abs() * 2.0**-11).all()  # within half a step


@SHAPES
def test_three_tf32_products_meet_the_f32_bar(B, T, H, D):
    readings = _readings(B, T, H, D, products=3)
    over = {name: A.over_tolerance(m, torch.float32) for name, m in readings.items()}
    assert not any(over.values()), over
    # ~10x inside the bar, as the kernels' design counts on
    assert max(m["rel_l2"] for m in readings.values()) < A.MATCH_TOL[torch.float32]["rel_l2"] / 5, readings


@SHAPES
def test_one_tf32_product_misses_the_f32_bar(B, T, H, D):
    readings = _readings(B, T, H, D, products=1)
    for name in ("out", "dq"):
        assert A.over_tolerance(readings[name], torch.float32), (name, readings[name])


def _rtz(x):
    """f64 x rounded toward zero to f32: the low 29 of the 52 mantissa bits
    cleared, which leaves f32's 23 (exact inside f32's normal range, where
    every sum here lies), then converted without rounding."""
    return (x.view(torch.int64) & -0x20000000).view(torch.float64).float()


def _mma_sum(a, b, fresh):
    """a @ b ([..., M, K] @ [..., K, N]) as the kernels take it: k-chunks of
    8, each as three TF32 products on mma.sync, whose accumulator adds the
    exact products and rounds the sum toward zero. fresh=False sums the
    chunks in that accumulator; fresh=True takes each chunk's three in a
    fresh one and adds it to the sum by an f32 add (to nearest)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    terms = [(x.double(), y.double()) for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))]
    c = torch.zeros(*a.shape[:-1], b.shape[-1])
    for j in range(0, a.shape[-1], 8):
        d = torch.zeros_like(c) if fresh else c
        for x, y in terms:
            d = _rtz(d.double() + x[..., j:j + 8] @ y[..., j:j + 8, :])
        c = c + d if fresh else d
    return c


def _accumulated_readings(scores_fresh, rows_fresh):
    """out and dq of causal attention at D 128 over 1024 keys, S and dP (D / 8
    = 16 chunks) and P V, dS K (a chunk per 8 keys) each summed as
    `scores_fresh` and `rows_fresh` say, against the plain versions."""
    rng = np.random.default_rng(17)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((1, 1024, 1, 128), dtype=np.float32)) for _ in range(4))
    scale = 128**-0.5
    out, lse = A._plain_flash_fwd(q, k, v, True, scale, 0)
    dq, _, _ = A._plain_flash_bwd(q, k, v, out, lse, dout, True, scale, 0)
    qh, kh, vh, dh = (x.transpose(1, 2) for x in (q, k, v, dout))
    s = _mma_sum(qh, kh.transpose(-1, -2), scores_fresh) * scale
    s = s.masked_fill(~torch.ones(1024, 1024, dtype=torch.bool).tril(), -math.inf)
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    got_out = _mma_sum(p, vh, rows_fresh)
    dp = _mma_sum(dh, vh.transpose(-1, -2), scores_fresh)
    ds = p * (dp - (dh * got_out).sum(-1, keepdim=True)) * scale
    got_dq = _mma_sum(ds, kh, rows_fresh)
    return {"out": A.mismatch(got_out.transpose(1, 2), out), "dq": A.mismatch(got_dq.transpose(1, 2), dq)}


def test_where_the_kernels_sum_in_the_accumulator():
    """The kernels' choice of where to sum (flash_tf32.cuh): the forward sums
    a score's 16 chunks in the tensor cores' accumulator, which rounds toward
    zero, and its output stays well inside the f32 bar; its rows of 128
    chunks summed there too drift further. dQ sums every chunk apart: its
    scores in the accumulator would drift further still (dS = P (dP - Delta)
    cancels)."""
    scores_in_acc = _accumulated_readings(scores_fresh=False, rows_fresh=True)
    all_in_acc = _accumulated_readings(scores_fresh=False, rows_fresh=False)
    all_fresh = _accumulated_readings(scores_fresh=True, rows_fresh=True)
    bar = A.MATCH_TOL[torch.float32]
    out, dq = scores_in_acc["out"], all_fresh["dq"]  # as the forward and dQ sum
    for name, m in (("out", out), ("dq", dq)):
        assert not A.over_tolerance(m, torch.float32), (name, m)
        assert m["rel_l2"] < bar["rel_l2"] / 3 and m["elem"] < bar["elem"] / 5, (name, m)
    assert all_in_acc["out"]["rel_l2"] > 1.5 * out["rel_l2"], (all_in_acc["out"], out)
    assert scores_in_acc["dq"]["rel_l2"] > 2 * dq["rel_l2"], (scores_in_acc["dq"], dq)


def _dkv_readings(scores_fresh):
    """dk and dv of causal attention at D 128 over 1024 queries as the f32
    dK/dV kernel takes them: S^T = K Q^T and dP^T = V dO^T (D / 8 = 16
    chunks) summed as `scores_fresh` says, dV = P^T dO and dK = dS^T Q (a
    chunk per 8 queries) each chunk apart, from the plain lse and Delta,
    against the plain versions."""
    rng = np.random.default_rng(17)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((1, 1024, 1, 128), dtype=np.float32)) for _ in range(4))
    scale = 128**-0.5
    out, lse = A._plain_flash_fwd(q, k, v, True, scale, 0)
    _, dk, dv = A._plain_flash_bwd(q, k, v, out, lse, dout, True, scale, 0)
    delta = (dout * out).sum(-1).transpose(1, 2)  # [1, 1, Tq]
    qh, kh, vh, dh = (x.transpose(1, 2) for x in (q, k, v, dout))
    st = _mma_sum(kh, qh.transpose(-1, -2), scores_fresh) * scale  # [1, 1, Tk, Tq]
    seen = torch.ones(1024, 1024, dtype=torch.bool).triu()  # key j seen by query i >= j
    pt = torch.where(seen, torch.exp(st - lse[..., None, :]), 0.0)
    dpt = _mma_sum(vh, dh.transpose(-1, -2), scores_fresh)
    dst = pt * (dpt - delta[..., None, :]) * scale
    got_dv, got_dk = _mma_sum(pt, dh, True), _mma_sum(dst, qh, True)
    return {"dk": A.mismatch(got_dk.transpose(1, 2), dk), "dv": A.mismatch(got_dv.transpose(1, 2), dv)}


def test_where_the_dkv_kernel_sums():
    """The f32 dK/dV kernel's choice (flash_bwd.cu): S^T and dP^T each chunk
    apart, as dQ's S and dP, and every sum over queries apart: dk and dv lie
    well inside the f32 bar. S^T and dP^T summed in the tensor cores'
    accumulator drift further out (dS^T = P^T (dP^T - Delta) cancels)."""
    fresh, in_acc = _dkv_readings(scores_fresh=True), _dkv_readings(scores_fresh=False)
    bar = A.MATCH_TOL[torch.float32]
    for name, m in fresh.items():
        assert not A.over_tolerance(m, torch.float32), (name, m)
        assert m["rel_l2"] < bar["rel_l2"] / 5 and m["elem"] < bar["elem"] / 5, (name, m)
    assert in_acc["dk"]["rel_l2"] > 2 * fresh["dk"]["rel_l2"], (in_acc["dk"], fresh["dk"])
    assert in_acc["dk"]["elem"] > 2 * fresh["dk"]["elem"], (in_acc["dk"], fresh["dk"])
