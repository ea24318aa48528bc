"""Split TF32 ("3xTF32") in plain PyTorch: the arithmetic of the float32
bodies of B8 and B9 (``csrc/tf32.cuh``), for the tests on the CPU.

An f32 value x is hi = tf32(x) plus lo = tf32(x - hi), where tf32 keeps 10
explicit mantissa bits, rounding to nearest with ties away from zero on
the f32 bits (``cvt.rna.tf32.f32``); x - hi is exact in f32. A product
a @ b is hi_a @ hi_b + hi_a @ lo_b + lo_a @ hi_b, each term an exact
product of TF32 values summed in f32: what is left out, lo_a @ lo_b and
lo's own rounding, is near 2^-22 of |a| |b| a term.

Nothing on the port's main path calls this module: the plain versions of
B8 and B9 take ``mm`` as an argument (``torch.matmul`` by default) and a
test passes ``mm_3xtf32`` to run their dataflow through the kernels'
arithmetic.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

_HALF_ULP = 1 << 12          # half of TF32's last place in the f32 bits
_KEEP = ~((1 << 13) - 1)     # the bits TF32 keeps: sign, exponent, 10


def round_tf32(x: Tensor) -> Tensor:
    """x (float32) rounded to TF32, ties away from zero: the f32 bits plus
    half a TF32 place, the low 13 bits cleared. The bits are sign and
    magnitude, so the add rounds |x| whatever the sign; a carry into the
    exponent is the right result, and inf stays inf."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + _HALF_ULP) & _KEEP).view(torch.float32)


def split_tf32(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(hi, lo) = (tf32(x), tf32(x - hi)) of a float32 tensor."""
    hi = round_tf32(x)
    return hi, round_tf32(x.float() - hi)


def mm_3xtf32(a: Tensor, b: Tensor) -> Tensor:
    """a @ b (float32, ``torch.matmul``'s broadcasting) as the kernels take
    it: a_hi b_hi + a_hi b_lo + a_lo b_hi."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (torch.matmul(ah, bh) + torch.matmul(ah, bl)
            + torch.matmul(al, bh))
