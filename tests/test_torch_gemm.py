"""The bf16 GEMM of B1's and B13's products (``ops/kernels/gemm.py``) and
the shared bf16 window core's host-side rules, on the CPU.

* ``gemm_plain`` (the GEMM kernels' plain version) against the JAX
  package's products as B13's TPU kernel forms them (``vit_block.py``
  ``_ln_mlp_kernel``: an f32 ``dot_general`` plus the bias, the sum rounded
  to bf16 and then ``_gelu_tanh``; the residual added in f32), with each
  epilogue.
* The Python mirrors of what the card decides: which kernel takes a shape
  (``gemm_kernel``, ``csrc/gemm_sm90.cuh`` ``sm90_takes``), the wgmma
  kernel's shared memory (``sm90_smem_bytes``) and the window core's
  (``core_smem_bytes``, ``window_core.cuh`` ``WinCoreLayout``) against a
  block's 232,448 bytes, and the core's window limit.

Inputs come from numpy seeds; the bf16 comparisons allow two bf16 steps at
max|ref| (a sum in another order may round a value the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import to_np

from ullsam_tpu.ops.pallas import vit_block as JVB
from ullsam_tpu_torch.ops.kernels import gemm as G
from ullsam_tpu_torch.ops.kernels import vit_block as TVB
from ullsam_tpu_torch.ops.kernels import window_attention as TWA

# (N, K) of B1's qkv and proj and B13's fc1 and fc2 at SAM ViT-B, L, H
_SAM_PRODUCTS = [(3 * C, C) for C in (768, 1024, 1280)] + [
    (C, C) for C in (768, 1024, 1280)] + [
    (4 * C, C) for C in (768, 1024, 1280)] + [
    (C, 4 * C) for C in (768, 1024, 1280)]


def _bf16_step(ref):
    m = float(np.abs(to_np(ref)).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) / m


def _rel(got, ref):
    got, ref = to_np(got), to_np(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_sm90_shape_rule():
    """Every bf16 product of B1 and B13 at SAM's widths, at any M (4900,
    4096, ragged), takes the wgmma kernel; shapes off its tiles (N % 128,
    K % 64) take the mma.sync kernel; its shared memory fits a block."""
    for N, K in _SAM_PRODUCTS:
        for M in (4900, 4096, 257, 1):
            assert G.gemm_kernel(M, N, K) == "gemm_sm90"
    for M, N, K in ((300, 200, 96), (64, 136, 64), (64, 64, 64),
                    (4900, 1280, 32), (0, 128, 64)):
        assert G.gemm_kernel(M, N, K) == "gemm_mma"
    assert G.sm90_smem_bytes() == 199776
    assert G.sm90_smem_bytes() <= G.SMEM_LIMIT == 232448


@pytest.mark.parametrize("M,N,K", [(37, 128, 64), (5, 256, 128)])
@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
def test_gemm_plain_matches_jax(M, N, K, epilogue):
    """``gemm_plain`` against B13's TPU-kernel arithmetic in JAX on
    the same bf16 inputs: fc1's bias + GELU, fc2's bias + residual."""
    rng = np.random.default_rng(7)
    a = (rng.standard_normal((M, K))).astype(np.float32)
    w = (rng.standard_normal((N, K)) * K ** -0.5).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    r = rng.standard_normal((M, N)).astype(np.float32)
    bf = jnp.bfloat16
    ja, jw, jb, jr = (jnp.asarray(x).astype(bf) for x in (a, w, b, r))
    acc = jax.lax.dot_general(ja, jw.T, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32) + jb
    act = "none"
    if epilogue == "gelu":
        want = JVB._gelu_tanh(acc.astype(bf))
        act = "gelu_tanh"
    elif epilogue == "residual":
        want = (jr.astype(jnp.float32) + acc).astype(bf)
    else:
        want = acc.astype(bf)
    ta, tw, tb, tr = (torch.from_numpy(x).bfloat16() for x in (a, w, b, r))
    got = G.gemm_bf16(ta, tw, tb, tr if epilogue == "residual" else None,
                      act)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    want = np.asarray(want.astype(jnp.float32))
    assert _rel(got, want) <= 2 * _bf16_step(want)


def test_gemm_plain_is_b13s_products():
    """B13's plain version is LN followed by the GEMM's two products:
    fc1 with the GELU epilogue, fc2 with x as the residual."""
    rng = np.random.default_rng(3)
    T_, C, F = 40, 128, 256
    x, w1, w2 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .bfloat16() for s in ((T_, C), (F, C), (C, F)))
    lw, lb, b1, b2 = (torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * 0.1).bfloat16()
        for s in ((C,), (C,), (F,), (C,)))
    from ullsam_tpu_torch.ops import layers as L
    y = L.layer_norm(x, lw + 1, lb, eps=1e-6)
    h = G.gemm_plain(y, w1, b1, None, "gelu_tanh")
    got = G.gemm_plain(h, w2, b2, x)
    want = TVB.ln_mlp_plain(x, lw + 1, lb, w1, b1, w2, b2, eps=1e-6)
    assert torch.equal(got, want)


def test_gemm_counts_need_no_card():
    """The GEMM kernels' launch counts read 0 with no library loaded, can
    be set to 0, and a CPU product launches nothing."""
    for c in (G.gemm_sm90, G.gemm_mma):
        c.launches = 0
        assert c.launches == 0
    a = torch.randn(4, 64).bfloat16()
    G.gemm_bf16(a, torch.randn(128, 64).bfloat16())
    assert (G.gemm_sm90.launches, G.gemm_mma.launches) == (0, 0)


def test_f32_kernel_counts_need_no_card():
    """The f32 GEMMs' and the f32 window core's launch counts read 0 with
    no library loaded, can be set to 0, and CPU calls launch nothing."""
    counts = (G.gemm_sm90_f32, G.gemm_fma, TWA.window_core_f32)
    for c in counts:
        c.launches = 0
        assert c.launches == 0
    G.gemm_f32(torch.randn(4, 64), torch.randn(128, 64))
    TWA.window_attn_core(torch.randn(32, 3 * 128), torch.randn(4, 4, 64),
                         torch.randn(4, 4, 64))
    assert [c.launches for c in counts] == [0, 0, 0]


@pytest.mark.parametrize("M,N,K", [(37, 128, 64), (300, 256, 128)])
@pytest.mark.parametrize("act", ["none", "gelu_tanh"])
def test_gemm_f32_plain_is_the_fma_kernels_function(M, N, K, act):
    """``gemm_f32`` on the CPU is ``gemm_plain`` in float32: the f32 sum,
    bias and residual added in f32, the tanh-GELU of the unrounded sum;
    with ``mm=tf32.mm_3xtf32`` (the wgmma kernel's split TF32) within 1e-6
    of it."""
    from ullsam_tpu_torch.ops.kernels import tf32 as T
    rng = np.random.default_rng(M + K)
    a, w, b, r = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((M, K), (N, K), (N,), (M, N)))
    got = G.gemm_f32(a, w, b, r, act)
    want = a @ w.T + b + r
    if act == "gelu_tanh":
        want = TVB.gelu_tanh(want)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6
    split = G.gemm_plain(a, w, b, r, act, mm=T.mm_3xtf32)
    assert _rel(split, got) <= 1e-6


@pytest.mark.parametrize("hd", [64, 80])
def test_window_core_smem_fits_a_block(hd):
    """The window cores' shared memory fits one H100 block at every window
    they take, up to 16x16: the bf16 core's (two k|v and two q slots, the
    unit's rel terms) and the f32 core's (k's, then v's, hi and lo planes
    in the slot rows of its instance, a query half's rows and rel terms).
    B1, B3 and B15 run these two cores."""
    for kh in range(1, 17):
        for kw in range(1, 17):
            n = kh * kw
            got = TWA.core_smem_bytes(n, kh, kw, hd)
            assert got <= TWA._SMEM_LIMIT == 232448
            assert TWA.core_f32_smem_bytes(n, kh, kw, hd) <= TWA._SMEM_LIMIT
    assert TWA.core_smem_bytes(196, 14, 14, 80) == 191744
    assert TWA.core_smem_bytes(256, 16, 16, 80) == 221184
    assert TWA.core_f32_smem_bytes(196, 14, 14, 80) == 200704
    assert TWA.core_f32_smem_bytes(256, 16, 16, 80) == 231424


def test_window_core_window_limit():
    """On the card the window cores of both dtypes take windows up to
    16x16 (one 16-key slot a window row); the CPU runs the plain version at
    any window."""
    for dt in (torch.bfloat16, torch.float32):
        TWA.check_core_window(dt, 16, 16, "t")
        with pytest.raises(ValueError):
            TWA.check_core_window(dt, 4, 32, "t")
    qkv = torch.randn(2 * 4 * 17, 3 * 64).bfloat16()
    rh, rw = torch.randn(4, 4, 64).bfloat16(), torch.randn(17, 17, 64).bfloat16()
    assert TWA.window_attn_core(qkv, rh, rw).shape == (2 * 4 * 17, 64)
