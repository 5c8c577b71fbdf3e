"""Exact f32 fused multiply-adds in plain torch.

The list path's pairwise cross term and the count-kernel studies' K = 3
products round as one fused multiply-add chain (what XLA-CPU's dot and
`torch.matmul` on the CPU compute, and what the CUDA kernels write with
`__fmaf_rn`).  On the card a float32 matmul goes to cuBLAS, whose K = 3
order is not promised, so the plain versions spell the chain out with
these functions on every device.
"""

from __future__ import annotations

import torch


def fma_f32(a, b, c):
    """a * b + c for f32 tensors, rounded once to f32 (a fused
    multiply-add).  The product is exact in f64; the f64 sum s and its
    exact error e (TwoSum) give a * b + c = s + e, and s rounded to odd
    (stepped one ulp toward e when inexact and even) then rounds to f32
    correctly, with no double rounding."""
    a, b, c = (x.to(torch.float64) for x in (a, b, c))
    prod = a * b
    s = prod + c
    bb = s - prod
    e = (prod - (s - bb)) + (c - bb)
    step = (e != 0.0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(e > 0.0, float("inf"), float("-inf"))
    s = torch.where(step, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def dot3(a0, b0, a1, b1, a2, b2):
    """a0*b0 + a1*b1 + a2*b2 as XLA-CPU computes a K = 3 dot_general (and
    sum(x * x) over 3): fma(a2, b2, fma(a1, b1, a0 * b0))."""
    return fma_f32(a2, b2, fma_f32(a1, b1, a0 * b0))
