"""The plain versions of the train step's kernels against the TPU kernels
they replace (Pallas interpret mode on the CPU, as the JAX package's own
tests run them) and against the JAX package's XLA formulations under
``jax.vjp``; plus the gradients of B1's and B2's autograd Functions.

B3 ``window_attn_core``     <- flash_attention.py ``_vit_window_kernel``
B8 ``window_attn_core_bwd`` <- flash_attention.py ``_vit_window_bwd_kernel``
B9 ``vit_flash_attn_bwd``   <- flash_attention.py ``_vit_bwd_dq_kernel`` and
                               ``_vit_bwd_dkv_kernel``

Layouts are converted at the test: the JAX side pads each head to 128
lanes (qkvp [B, N, 3*nh*128]) and keeps the gathered tables as rhf
[128, kh*kh] with rhf[d, r*kh + i] = Rh[r, i, d]; the port keeps qkv
[B*N, 3C] and rh [kh, kh, hd].

Tolerances (max|got - ref| over max|ref| unless stated): f32 against the
XLA math 2e-5 (the same math, another summation order); f32 against the
TPU kernels 1e-4 (they rebuild the f32 bias from bf16 hi + lo parts,
``_bias_select``, exact to ~2^-16 of |bias|); bf16 3e-2 as
tests/test_kernels.py:619 (different sums can round a p or ds to the
neighbouring bf16 step); the Function gradients as tests/test_kernels.py
bounds them: 1e-5 absolute for B2 (f32) and 1e-3 for B1 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_helpers import to_np

from ullsam_tpu.models.sam import image_encoder as JIE
from ullsam_tpu.ops.pallas import flash_attention as JFA
from ullsam_tpu.ops.pallas import vit_block as JVB
from ullsam_tpu_torch.ops import attention as TA
from ullsam_tpu_torch.ops.kernels import flash_attention as TFA
from ullsam_tpu_torch.ops.kernels import vit_block as TVB
from ullsam_tpu_torch.ops.kernels import window_attention as TWA

HP = JFA._HP


def _rel(a, b):
    a, b = to_np(a), to_np(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _window_core_case(seed, nh=3, hd=64, ws=4, B=5):
    """Natural-layout inputs and their packed JAX counterparts."""
    rng = np.random.default_rng(seed)
    n = ws * ws
    C = nh * hd
    qkv = (rng.standard_normal((B * n, 3 * C)) * 0.3).astype(np.float32)
    rh = (rng.standard_normal((ws, ws, hd)) * 0.2).astype(np.float32)
    rw = (rng.standard_normal((ws, ws, hd)) * 0.2).astype(np.float32)
    do = (rng.standard_normal((B * n, C)) * 0.5).astype(np.float32)
    return qkv, rh, rw, do, (nh, hd, ws, B)


def _pack_qkv(qkv, nh, hd, B):
    n = qkv.shape[0] // B
    x = qkv.reshape(B, n, 3, nh, hd)
    return np.pad(x, ((0, 0),) * 4 + ((0, HP - hd),)).reshape(B, n, -1)


def _pack_out(o, nh, hd, B):
    n = o.shape[0] // B
    return np.pad(o.reshape(B, n, nh, hd), ((0, 0),) * 3 + ((0, HP - hd),)
                  ).reshape(B, n, -1)


def _unpack(a, parts, nh, hd):
    B, n, _ = a.shape
    return np.asarray(a, np.float32).reshape(B, n, parts, nh, HP)[
        ..., :hd].reshape(B * n, parts * nh * hd)


def _pack_table(r):
    k, _, hd = r.shape
    return np.pad(r.transpose(2, 0, 1).reshape(hd, k * k), ((0, HP - hd),
                                                             (0, 0)))


def _unpack_table(f, k, hd):
    return np.asarray(f, np.float32)[:hd].reshape(hd, k, k).transpose(1, 2, 0)


def test_window_core_plain_matches_tpu_kernel_and_xla():
    """B3 plain vs the interpret-mode ``vit_window_attention_packed`` and vs
    ``_window_packed_xla`` (f32; a 4x4 window, 3 heads of 64)."""
    qkv, rh, rw, _, (nh, hd, ws, B) = _window_core_case(0)
    args = (jnp.asarray(_pack_qkv(qkv, nh, hd, B)),
            jnp.asarray(_pack_table(rh)), jnp.asarray(_pack_table(rw)))
    with pltpu.force_tpu_interpret_mode():
        ref_k = JFA.vit_window_attention_packed(*args, nh, hd, ws, ws)
    ref_x = JFA._window_packed_xla(*args, nh, hd, ws, ws)
    got = TWA.window_attn_core_plain(*(torch.from_numpy(a)
                                       for a in (qkv, rh, rw)))
    assert got.shape == (B * ws * ws, nh * hd)
    assert _rel(got, _unpack(ref_k, 1, nh, hd)) < 1e-4
    assert _rel(got, _unpack(ref_x, 1, nh, hd)) < 2e-5


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_window_core_bwd_plain_matches_tpu_kernel_and_vjp(dt, hd):
    """B8 plain vs ``_vit_window_packed_bwd_impl`` in interpret mode and vs
    ``jax.vjp(_window_packed_xla)`` on dqkv, drh and drw, at SAM ViT-B's
    head dim (64) and ViT-H's (80)."""
    qkv, rh, rw, do, (nh, hd, ws, B) = _window_core_case(1, hd=hd)
    jdt = jnp.float32 if dt == "float32" else jnp.bfloat16
    tdt = getattr(torch, dt)
    args = (jnp.asarray(_pack_qkv(qkv, nh, hd, B)).astype(jdt),
            jnp.asarray(_pack_table(rh)), jnp.asarray(_pack_table(rw)))
    g = jnp.asarray(_pack_out(do, nh, hd, B)).astype(jdt)
    with pltpu.force_tpu_interpret_mode():
        ref_k = JFA._vit_window_packed_bwd_impl(*args, g, nh, hd, ws, ws)
    _, vjp = jax.vjp(lambda a, b, c: JFA._window_packed_xla(
        a, b, c, nh, hd, ws, ws), *args)
    ref_x = vjp(g)
    got = TWA.window_attn_core_bwd_plain(
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(rh),
        torch.from_numpy(rw), torch.from_numpy(do).to(tdt))
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    tol_k, tol_x = (1e-4, 2e-5) if dt == "float32" else (3e-2, 3e-2)
    for ref, tol in ((ref_k, tol_k), (ref_x, tol_x)):
        assert _rel(got[0], _unpack(ref[0], 3, nh, hd)) < tol
        assert _rel(got[1], _unpack_table(ref[1], ws, hd)) < tol
        assert _rel(got[2], _unpack_table(ref[2], ws, hd)) < tol


@pytest.mark.parametrize("dt,hd", [(torch.bfloat16, 64),
                                   (torch.bfloat16, 80),
                                   (torch.float32, 64),
                                   (torch.float32, 80)])
def test_window_core_bwd_smem_fits_a_block(dt, hd):
    """B8's shared-memory mirror (``bwd_smem_bytes``, the kernel's
    ``BwdMma`` / ``BwdTf32``) fits one H100 block at SAM's 14x14 windows
    for every head dim the wrapper takes: bf16 and f32 {64, 80}. Four f32
    window tiles [208][84] would take 279,552 bytes at ViT-H's head dim 80,
    so the f32 kernel holds two and restages them, beside a [16][hd + 4]
    tile a warp: 208,576 bytes (173,760 at 64); 16x16 windows at 80 stay
    over the block."""
    assert TWA._BWD_HEAD_DIMS == {torch.bfloat16: (64, 80),
                                  torch.float32: (64, 80)}
    assert hd in TWA._BWD_HEAD_DIMS[dt]
    assert TWA.bwd_smem_bytes(dt, 196, 14, 14, hd) <= TWA._SMEM_LIMIT == 232448
    assert TWA.bwd_smem_bytes(torch.float32, 196, 14, 14, 80) == 208576
    assert TWA.bwd_smem_bytes(torch.float32, 196, 14, 14, 64) == 173760
    assert TWA.bwd_smem_bytes(torch.float32, 256, 16, 16, 80) > 232448


def test_window_core_bwd_f32_instances_match_the_source():
    """B8's float32 kernel is compiled for the key-tile counts of
    ``csrc/window_attn_bwd.cu`` ``kTf32Nts``, which the mirror
    ``tf32_key_tiles`` names: every window up to 16x16 runs the smallest
    instance that holds its keys (SAM's 14x14 exactly 13 tiles)."""
    import os
    import re
    from ullsam_tpu_torch.ops.kernels import build
    with open(os.path.join(build.CSRC, "window_attn_bwd.cu")) as f:
        m = re.search(r"kTf32Nts\[\] = \{([\d, ]+)\}", f.read())
    assert tuple(int(x) for x in m.group(1).split(",")) == \
        TWA.TF32_KEY_TILES
    for n in range(1, 257):
        t = TWA.tf32_key_tiles(n)
        assert 16 * t >= n
        assert all(16 * s < n for s in TWA.TF32_KEY_TILES if s < t)
    assert TWA.tf32_key_tiles(196) == 13


def test_window_core_function_gradients_are_b8():
    """``window_attention`` (the B3 Function) differentiates to the plain
    B8 on the CPU, for every input, and matches autograd of B3's plain
    version."""
    qkv, rh, rw, do, _ = _window_core_case(2, nh=2, ws=3, B=2)
    ins = [torch.from_numpy(a).double().float().requires_grad_()
           for a in (qkv, rh, rw)]
    out = TWA.window_attention(*ins)
    got = torch.autograd.grad(out, ins, torch.from_numpy(do))
    ref = TWA.window_attn_core_bwd_plain(*(t.detach() for t in ins),
                                         torch.from_numpy(do))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    ins2 = [t.detach().requires_grad_() for t in ins]
    auto = torch.autograd.grad(TWA.window_attn_core_plain(*ins2), ins2,
                               torch.from_numpy(do))
    for a, b in zip(got, auto):
        assert _rel(a, b) < 2e-5


def _flash_case(seed, B=2, KH=16, KW=16, D=64):
    rng = np.random.default_rng(seed)
    N = KH * KW
    qkv = [(rng.standard_normal((B, N, D)) * 0.5).astype(np.float32)
           for _ in range(3)]
    rel = [(rng.standard_normal((B, N, K)) * 0.3).astype(np.float32)
           for K in (KH, KW)]
    do = (rng.standard_normal((B, N, D)) * 0.5).astype(np.float32)
    return qkv + rel, do


def _b9_inputs(args, do):
    """Torch B9 inputs: the plain forward's (o, lse) and dd = sum(do * o)."""
    t = [torch.from_numpy(a) for a in args]
    o, lse = TFA.vit_flash_attn_plain(*t)
    g = torch.from_numpy(do)
    return t, g, lse, (g * o).sum(-1)


@pytest.mark.parametrize("D", [64, 80])
def test_vit_flash_bwd_plain_matches_tpu_kernel_and_vjp(D):
    """B9 plain vs ``_vit_flash_bwd_impl`` in interpret mode (N = 256,
    blocks 128) and vs ``jax.vjp(_vit_attention_xla)``, on dq, dk, dv,
    drel_h and drel_w (f32), at SAM ViT-B's head dim (64) and ViT-H's
    (80)."""
    args, do = _flash_case(3, D=D)
    jargs = [jnp.asarray(a) for a in args]
    with pltpu.force_tpu_interpret_mode():
        o, lse = JFA._vit_flash_impl(*jargs, 128, 128)
        ref_k = JFA._vit_flash_bwd_impl(*jargs, o, lse, jnp.asarray(do),
                                        128, 128)
    _, vjp = jax.vjp(JFA._vit_attention_xla, *jargs)
    ref_x = vjp(jnp.asarray(do))
    t, g, lse_t, dd = _b9_inputs(args, do)
    got = TFA.vit_flash_attn_bwd_plain(*t, g, lse_t, dd)
    names = ("dq", "dk", "dv", "drel_h", "drel_w")
    for ref, tol in ((ref_k, 1e-4), (ref_x, 2e-5)):
        for name, a, b in zip(names, got, ref):
            assert _rel(a, b) < tol, (name, _rel(a, b))


def _rel_l2(a, b):
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("D", [64, 80])
def test_vit_flash_bwd_plain_bf16_matches_tpu_kernel(D):
    """B9 plain in bf16 vs the TPU backward kernels at bf16 inputs, both fed
    the TPU forward's o and lse, at head dims 64 and 80: relative L2 within
    1e-3 on every gradient. The plain version scores as the TPU kernels do
    (f32(q k^T) * D^-1/2 from unscaled q, dq and dk scaled after their
    products); scoring from B2's cast(q * D^-1/2) instead agrees at 64 (a
    power-of-two scale) and is 1.4e-3 to 3.0e-3 away at 80."""
    args, do = _flash_case(4, D=D)
    bf = jnp.bfloat16
    jargs = [jnp.asarray(a).astype(bf) for a in args[:3]] + [
        jnp.asarray(a) for a in args[3:]]
    with pltpu.force_tpu_interpret_mode():
        o, lse = JFA._vit_flash_impl(*jargs, 128, 128)
        ref = JFA._vit_flash_bwd_impl(*jargs, o, lse,
                                      jnp.asarray(do).astype(bf), 128, 128)
    t = [torch.from_numpy(a) for a in args]
    t = [x.to(torch.bfloat16) for x in t[:3]] + t[3:]
    lse_t = torch.from_numpy(np.asarray(lse)[..., 0].copy())
    o_t = torch.from_numpy(to_np(o))
    g = torch.from_numpy(do).to(torch.bfloat16)
    dd = (g.float() * o_t).sum(-1)
    got = TFA.vit_flash_attn_bwd_plain(*t, g, lse_t, dd)
    for name, a, b in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, ref):
        assert a.dtype == (torch.bfloat16 if name[1] != "r" else
                           torch.float32), name
        assert _rel_l2(a, b) < 1e-3, (name, _rel_l2(a, b))


@pytest.mark.parametrize("D", [64, 80])
def test_vit_flash_function_gradients_match_jax_grad(D):
    """``vit_flash_attention`` (the B2 Function; its backward is B9) vs
    ``jax.grad`` of ``vit_flash_attention`` in interpret mode, as
    tests/test_kernels.py:60-80 holds the TPU pair, at head dims 64 and
    80."""
    args, _ = _flash_case(5, D=D)
    jargs = [jnp.asarray(a) for a in args]
    with pltpu.force_tpu_interpret_mode():
        gref = jax.grad(lambda *a: jnp.sum(JFA.vit_flash_attention(
            *a, 128, 128) ** 2), argnums=(0, 1, 2, 3, 4))(*jargs)
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    out = TFA.vit_flash_attention(*ins)
    got = torch.autograd.grad((out ** 2).sum(), ins)
    assert got[3].dtype == torch.float32
    for name, a, b in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, gref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-5,
                                   err_msg=name)


def test_window_attn_function_gradients_match_jax_vjp():
    """The B1 Function's gradients (backward: PyTorch recompute, B3's
    Function, B8) vs ``jax.vjp`` of ``_window_attn_call`` in interpret mode
    on a padded window grid, for x and every weight, in f32."""
    from test_torch_kernels import _window_case, _window_torch_args
    blk, xw, geom, nh, hd, ws = _window_case(np.float32, seed=6)
    f32 = jnp.float32
    jblk = {k: {kk: (jnp.asarray(vv) if not isinstance(vv, dict) else
                     {a: jnp.asarray(b) for a, b in vv.items()})
                for kk, vv in v.items()} for k, v in blk.items()}
    qkvw, bqkv, wo, bo = JVB.pack_window_attn_weights(jblk, nh, hd, f32)
    rhf, rwf = JIE._rel_tables_packed(jblk["attn"], ws, ws, hd, f32)
    lns = jblk["norm1"]["scale"][None]
    lnb = jblk["norm1"]["bias"][None]
    rng = np.random.default_rng(7)
    g = rng.standard_normal(xw.shape).astype(np.float32)

    def f(x, a, b, c, d, e, ff, h, i):
        return JVB._window_attn_call(x, a, b, c, d, e, ff, h, i, 1, nh, hd,
                                     ws, ws, 1e-6, geom["nwx"], geom["nwy"],
                                     geom["Hv"], geom["Wv"], True)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, jnp.asarray(xw), lns, lnb, qkvw, bqkv, wo, bo,
                         rhf, rwf)
        ref = vjp(jnp.asarray(g))
    args = [t.requires_grad_() for t in
            _window_torch_args(blk, xw, ws, torch.float32)]
    before = (TWA.window_attn_core.launches,
              TWA.window_attn_core_bwd.launches)
    out = TVB.window_attn_block(*args, num_heads=nh, eps=1e-6, **geom)
    got = torch.autograd.grad(out, args, torch.from_numpy(g))
    # the CPU runs the plain versions: nothing is launched
    assert (TWA.window_attn_core.launches,
            TWA.window_attn_core_bwd.launches) == before
    C = nh * hd
    want = [np.asarray(ref[0]), np.asarray(ref[1])[0], np.asarray(ref[2])[0],
            _unpack(np.asarray(ref[3])[None], 3, nh, hd).T,
            _unpack(np.asarray(ref[4]).reshape(1, 1, -1), 3, nh, hd)[0],
            np.asarray(ref[5]).reshape(nh, HP, C)[:, :hd].reshape(C, C).T,
            np.asarray(ref[6])[0],
            _unpack_table(ref[7], ws, hd), _unpack_table(ref[8], ws, hd)]
    names = ("x", "norm_w", "norm_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
             "rh", "rw")
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(to_np(a), b, atol=1e-3, rtol=1e-3,
                                   err_msg=name)


def test_rel_pos_and_layer_ops_gradients_match_jax():
    """``get_rel_pos`` (with its resampling), ``decomposed_rel_pos_terms``,
    the one-pass LayerNorm and GELU differentiate as ``jax.grad`` of the JAX
    package's functions (f32, 1e-5 relative)."""
    from ullsam_tpu.ops import attention as JA
    from ullsam_tpu.ops import layers as JL
    from ullsam_tpu_torch.ops import layers as TL
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 6 * 5, 16)).astype(np.float32)
    rph = rng.standard_normal((9, 16)).astype(np.float32)   # resampled to 11
    rpw = rng.standard_normal((9, 16)).astype(np.float32)
    wt = rng.standard_normal((2, 6, 5, 6)).astype(np.float32)
    wt2 = rng.standard_normal((2, 6, 5, 5)).astype(np.float32)

    def jf(q_, h_, w_):
        a, b = JA.decomposed_rel_pos_terms(q_, h_, w_, (6, 5), (6, 5))
        return jnp.sum(a * wt) + jnp.sum(b * wt2)

    ref = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, rph, rpw)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, rph, rpw)]
    a, b = TA.decomposed_rel_pos_terms(*ins, (6, 5), (6, 5))
    got = torch.autograd.grad((a * torch.from_numpy(wt)).sum()
                              + (b * torch.from_numpy(wt2)).sum(), ins)
    for x, y in zip(got, ref):
        assert _rel(x, y) < 1e-5

    x = rng.standard_normal((4, 7, 48)).astype(np.float32) * 2 + 0.5
    sc, bi = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
    wt3 = rng.standard_normal((4, 7, 48)).astype(np.float32)

    def jln(x_, s_, b_):
        y = JL.layer_norm({"scale": s_, "bias": b_}, x_, eps=1e-6)
        return jnp.sum(JL.gelu(y) * wt3)

    ref = jax.grad(jln, argnums=(0, 1, 2))(*map(jnp.asarray, (x, sc, bi)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, sc, bi)]
    y = TL.gelu(TL.layer_norm(ins[0], ins[1], ins[2], eps=1e-6))
    got = torch.autograd.grad((y * torch.from_numpy(wt3)).sum(), ins)
    for xx, yy in zip(got, ref):
        assert _rel(xx, yy) < 1e-5


def test_train_kernel_wrappers_refuse_other_devices():
    """B3, B8 and B9 raise on a tensor that is neither on the CPU nor on a
    CUDA card; they never take the plain path there."""
    qkv, rh, rw, do, _ = _window_core_case(9)
    meta = [torch.from_numpy(a).to("meta") for a in (qkv, rh, rw, do)]
    with pytest.raises(ValueError):
        TWA.window_attn_core(*meta[:3])
    with pytest.raises(ValueError):
        TWA.window_attn_core_bwd(*meta)
    args, do = _flash_case(10)
    t = [torch.from_numpy(a).to("meta") for a in args]
    g = torch.from_numpy(do).to("meta")
    stat = torch.zeros(t[0].shape[:2], device="meta")
    with pytest.raises(ValueError):
        TFA.vit_flash_attn_bwd(*t, g, stat, stat)
