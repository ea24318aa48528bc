"""The plain versions of B13, B14 and B15 (``ullsam_tpu_torch``) against the
JAX package's opt-in TPU kernels in interpret mode on the CPU, and against
the XLA formulations kept beside them.

* B13 (``ops/kernels/vit_block.ln_mlp_plain``, ``fused_ln_mlp``) against
  ``_ln_mlp_xla`` and ``fused_ln_mlp`` under ``ULLSAM_FUSED_VIT_MLP=1``
  (``backend_ok`` patched to True, as ``tests/test_kernels.py:423`` runs
  it); forward and every gradient.
* B14 (``flash_attention.vit_flash_attention_packed`` through a global
  block's ``global_attention`` under ``ULLSAM_PACKED_GLOBAL=1``) against
  ``_vit_attention_global_packed`` (``tests/test_kernels.py:653``) at head
  dims 64 and 80; forward and every gradient. And the Function itself (its
  backward: the heads split, B9, dqkv packed) against ``jax.grad`` of
  ``vit_flash_attention_packed`` at head dims 64 and 80.
* B15 (``window_attention.window_attn_core_twophase_plain``) against
  ``vit_window_attention_packed`` under ``ULLSAM_WINDOW_TWOPHASE=1``
  (``tests/test_kernels.py:240``: 4 heads of 80, 6x6 windows), the
  128-lane packed layout converted to the natural one.

Inputs come from numpy seeds. Tolerances are float32's: the JAX kernels
rebuild the rel-pos bias with a bf16 hi + lo selection (each value to about
2^-16 relative) and sum in other orders, so results agree to about 1e-6
of their scale, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_helpers import to_np

from ullsam_tpu.core import config as JC
from ullsam_tpu.models.sam import image_encoder as JIE
from ullsam_tpu.ops.pallas import flash_attention as JFA
from ullsam_tpu.ops.pallas import vit_block as JVB
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.models.sam import image_encoder as TIE
from ullsam_tpu_torch.ops.kernels import flash_attention as TFA
from ullsam_tpu_torch.ops.kernels import vit_block as TVB
from ullsam_tpu_torch.ops.kernels import window_attention as TWA

T = torch.from_numpy


def _rel(got, ref):
    got, ref = to_np(got), to_np(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _bf16_step(ref):
    """One bf16 step at max|ref|, relative to max|ref| (2^-8 to 2^-7)."""
    m = float(np.abs(to_np(ref)).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) / m


def _calls(monkeypatch, module, name):
    """Count the calls of ``module.name`` (a plain version) from now on."""
    fn, n = getattr(module, name), []

    def counted(*a, **k):
        n.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return n


# ---------------------------------------------------------------------------
# B13
# ---------------------------------------------------------------------------


def _ln_mlp_operands(rng, Tn, C, F):
    x = (rng.standard_normal((Tn, C)) * 0.5).astype(np.float32)
    lns = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(C)).astype(np.float32)
    w1 = (rng.standard_normal((C, F)) * C ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(F)).astype(np.float32)
    w2 = (rng.standard_normal((F, C)) * F ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return x, lns, lnb, w1, b1, w2, b2


def _port_ln_mlp_args(x, lns, lnb, w1, b1, w2, b2, dtype=torch.float32):
    """The JAX [in, out] kernels as the port's [out, in] weights."""
    return [T(a.copy()).to(dtype) for a in
            (x, lns, lnb, w1.T, b1, w2.T, b2)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_ln_mlp_plain_matches_interpret_kernel(monkeypatch, dt):
    """B13's plain version against the interpret-mode Pallas kernel (300
    rows: the JAX entry pads them to its 512-row block) with the rounding
    points of the kernel: float32 within 1e-6 of max|out|; bfloat16 within
    three bf16 steps at max|out|: the two sum in other orders (and the CPU
    matmul's order may change with its thread count) before each of the
    three roundings, LN, fc1 and the GELU, and one flip in h moves the
    output by about a step. In float32 also against ``_ln_mlp_xla``. The
    CPU wrapper runs the plain version."""
    rng = np.random.default_rng(0)
    ops = _ln_mlp_operands(rng, 300, 128, 256)
    x, lns, lnb, w1, b1, w2, b2 = ops
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    monkeypatch.setattr("ullsam_tpu.ops.pallas.backend_ok", lambda: True)
    monkeypatch.setenv("ULLSAM_FUSED_VIT_MLP", "1")
    assert JVB.ln_mlp_supported(300, 128, 256)
    ln = {"scale": jnp.asarray(lns), "bias": jnp.asarray(lnb)}
    mlp = {"fc1": {"kernel": jnp.asarray(w1), "bias": jnp.asarray(b1)},
           "fc2": {"kernel": jnp.asarray(w2), "bias": jnp.asarray(b2)}}
    xj = jnp.asarray(x).astype(jdt)
    with pltpu.force_tpu_interpret_mode():
        ref = JVB.fused_ln_mlp(xj, ln, mlp, eps=1e-6)
    args = _port_ln_mlp_args(*ops, dtype=tdt)
    got = TVB.ln_mlp_plain(*args, eps=1e-6)
    assert got.dtype == tdt and got.shape == (300, 128)
    assert _rel(got, ref) <= (1e-6 if dt == "float32"
                              else 3 * _bf16_step(ref))
    if dt == "float32":
        xla = JVB._ln_mlp_xla(xj, *(jnp.asarray(a) for a in
                                    (lns, lnb, w1, b1, w2, b2)), 1e-6)
        assert _rel(got, xla) <= 1e-6
    calls = _calls(monkeypatch, TVB, "ln_mlp_plain")
    TVB.ln_mlp(*args, eps=1e-6)
    assert len(calls) == 1


def test_fused_ln_mlp_gradients_match_jax(monkeypatch):
    """``fused_ln_mlp`` (the ``LnMlp`` Function) against JAX's
    ``fused_ln_mlp`` under ``jax.grad`` (its custom vjp is the vjp of
    ``_ln_mlp_xla``), float32: the output and every input's gradient within
    1e-5 of its max."""
    rng = np.random.default_rng(1)
    ops = _ln_mlp_operands(rng, 2 * 150, 128, 256)
    x, lns, lnb, w1, b1, w2, b2 = ops
    monkeypatch.setattr("ullsam_tpu.ops.pallas.backend_ok", lambda: True)
    monkeypatch.setenv("ULLSAM_FUSED_VIT_MLP", "1")

    def jloss(xx, a, b, c, d, e, f):
        out = JVB.fused_ln_mlp(xx.reshape(2, 150, 128),
                               {"scale": a, "bias": b},
                               {"fc1": {"kernel": c, "bias": d},
                                "fc2": {"kernel": e, "bias": f}}, eps=1e-6)
        return jnp.sum(out ** 2), out

    with pltpu.force_tpu_interpret_mode():
        (_, jout), jg = jax.value_and_grad(jloss, argnums=tuple(range(7)),
                                           has_aux=True)(
            *(jnp.asarray(a) for a in ops))
    args = [a.requires_grad_() for a in _port_ln_mlp_args(*ops)]
    out = TVB.fused_ln_mlp(args[0].reshape(2, 150, 128), *args[1:],
                           eps=1e-6)
    (out ** 2).sum().backward()
    assert _rel(out, jout) <= 1e-6
    names = ("x", "ln scale", "ln bias", "fc1", "fc1 bias", "fc2", "fc2 bias")
    for name, a, g in zip(names, args, jg):
        g = np.asarray(g)
        if name in ("fc1", "fc2"):
            g = g.T
        assert _rel(a.grad, g) <= 1e-5, name


# ---------------------------------------------------------------------------
# B14
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", [64, 80])
def test_packed_global_attention_matches_interpret_kernel(monkeypatch, hd):
    """A global block's attention under ``ULLSAM_PACKED_GLOBAL=1`` (B14's
    plain version on the CPU) against ``_vit_attention_global_packed`` with
    the interpret-mode Pallas B14 and its custom vjp (the flash backward
    kernels in interpret mode), 2 heads over a 32x32 grid (N = 1024),
    float32: the output, x's and every parameter's gradient each within
    1e-5 of its max."""
    nh = 2
    cfg_kw = dict(img_size=512, patch_size=16, embed_dim=nh * hd, depth=1,
                  num_heads=nh, window_size=0, global_attn_indexes=(0,))
    jcfg, tcfg = JC.ViTConfig(**cfg_kw), TC.ViTConfig(**cfg_kw)
    H = W = 32
    rng = np.random.RandomState(0)
    params = JIE._attn_init(jax.random.PRNGKey(0), jcfg, (H, W))
    params = jax.tree.map(
        lambda a: np.asarray(rng.randn(*a.shape) * 0.05, np.float32), params)
    x = (rng.randn(1, H, W, nh * hd) * 0.2).astype(np.float32)

    def jloss(p, xx):
        out = JIE._vit_attention_global_packed(p, xx, jcfg)
        return jnp.sum(out ** 2), out

    with pltpu.force_tpu_interpret_mode():
        (_, jout), (jgp, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))

    monkeypatch.setenv("ULLSAM_PACKED_GLOBAL", "1")
    blk = TIE.Block(tcfg, 0, device="cpu")
    a = blk.attn
    with torch.no_grad():
        a.qkv.weight.copy_(T(params["qkv"]["kernel"].T.copy()))
        a.qkv.bias.copy_(T(params["qkv"]["bias"]))
        a.proj.weight.copy_(T(params["proj"]["kernel"].T.copy()))
        a.proj.bias.copy_(T(params["proj"]["bias"]))
        a.rel_pos_h.copy_(T(params["rel_pos_h"]))
        a.rel_pos_w.copy_(T(params["rel_pos_w"]))
    xt = T(x).requires_grad_()
    out = blk.global_attention(xt)
    (out ** 2).sum().backward()
    assert _rel(out, jout) <= 1e-5
    assert _rel(xt.grad, jgx) <= 1e-5, "x"
    for name, got, want in (
            ("qkv", a.qkv.weight.grad.T, jgp["qkv"]["kernel"]),
            ("qkv bias", a.qkv.bias.grad, jgp["qkv"]["bias"]),
            ("proj", a.proj.weight.grad.T, jgp["proj"]["kernel"]),
            ("proj bias", a.proj.bias.grad, jgp["proj"]["bias"]),
            ("rel_pos_h", a.rel_pos_h.grad, jgp["rel_pos_h"]),
            ("rel_pos_w", a.rel_pos_w.grad, jgp["rel_pos_w"])):
        assert _rel(got, want) <= 1e-5, name


@pytest.mark.parametrize("hd", [64, 80])
def test_packed_flash_gradients_match_jax_grad(hd):
    """``vit_flash_attention_packed`` (B14 forward; backward: the heads of
    qkv, o and the output gradient split, B9, dq, dk, dv packed into dqkv)
    against ``jax.grad`` of the JAX package's ``vit_flash_attention_packed``
    in interpret mode (its custom vjp: the flash backward kernels), 2 heads
    over a 16x16 key grid (N = 256, blocks of 128), float32: the output and
    the gradients of qkv, rel_h and rel_w each within 1e-5 of its max. The
    JAX side takes each head's hd channels left-aligned in a 128-lane slot;
    its pad lanes are sliced off."""
    B, nh, KH, KW = 1, 2, 16, 16
    N, C = KH * KW, nh * hd
    rng = np.random.default_rng(11)
    qkv = (rng.standard_normal((B, N, 3 * C)) * 0.5).astype(np.float32)
    rel_h = (rng.standard_normal((B * nh, N, KH)) * 0.3).astype(np.float32)
    rel_w = (rng.standard_normal((B * nh, N, KW)) * 0.3).astype(np.float32)
    w = rng.standard_normal((B, N, C)).astype(np.float32)
    qkvp = np.pad(qkv.reshape(B, N, 3, nh, hd),
                  ((0, 0),) * 4 + ((0, 128 - hd),)).reshape(B, N, -1)
    wp = np.pad(w.reshape(B, N, nh, hd),
                ((0, 0),) * 3 + ((0, 128 - hd),)).reshape(B, N, -1)

    ins = [T(a.copy()).requires_grad_() for a in (qkv, rel_h, rel_w)]
    out = TFA.vit_flash_attention_packed(*ins, nh)
    got = torch.autograd.grad((out * T(w)).sum(), ins)

    def jloss(a, b, c):
        out = JFA.vit_flash_attention_packed(a, b, c, nh, hd, 128, 128)
        return jnp.sum(out * jnp.asarray(wp)), out

    with pltpu.force_tpu_interpret_mode():
        (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
            jnp.asarray(qkvp), jnp.asarray(rel_h), jnp.asarray(rel_w))

    def unpad(a, parts):
        return np.asarray(a, np.float32).reshape(B, N, parts, nh, 128)[
            ..., :hd].reshape(B, N, parts * C)

    assert _rel(out, unpad(jout, 1)) <= 1e-5
    assert _rel(got[0], unpad(jg[0], 3)) <= 1e-5, "qkv"
    assert _rel(got[1], jg[1]) <= 1e-5, "rel_h"
    assert _rel(got[2], jg[2]) <= 1e-5, "rel_w"


# ---------------------------------------------------------------------------
# B15
# ---------------------------------------------------------------------------


def test_twophase_window_core_matches_interpret_kernel(monkeypatch):
    """B15's plain version (and B3's) against ``vit_window_attention_packed``
    with ``ULLSAM_WINDOW_TWOPHASE=1`` in interpret mode: 3 windows of 6x6
    tokens, 4 heads of 80, float32, within 1e-5 of max|o|. The JAX layout
    pads each head to 128 lanes; the port's is the natural one."""
    nh, hd, kh, kw, B = 4, 80, 6, 6, 3
    N, HP = kh * kw, JFA._HP
    rng = np.random.RandomState(0)
    qkvp = np.zeros((B, N, 3 * nh * HP), np.float32)
    for s in range(3):
        for h in range(nh):
            qkvp[:, :, (s * nh + h) * HP:(s * nh + h) * HP + hd] = \
                rng.randn(B, N, hd) * 0.3
    rhf = np.zeros((HP, kh * kh), np.float32)
    rwf = np.zeros((HP, kw * kw), np.float32)
    rhf[:hd] = rng.randn(hd, kh * kh) * 0.2
    rwf[:hd] = rng.randn(hd, kw * kw) * 0.2
    monkeypatch.setenv("ULLSAM_WINDOW_TWOPHASE", "1")
    with pltpu.force_tpu_interpret_mode():
        ref = JFA.vit_window_attention_packed(
            jnp.asarray(qkvp), jnp.asarray(rhf), jnp.asarray(rwf), nh, hd,
            kh, kw)
    ref = np.asarray(ref).reshape(B * N, nh, HP)[..., :hd].reshape(B * N, -1)
    qkv = T(qkvp.reshape(B * N, 3, nh, HP)[..., :hd].reshape(B * N, -1)
            .copy())
    # rhf[d, r * kh + i] = Rh[r, i, d]
    rh = T(rhf[:hd].reshape(hd, kh, kh).transpose(1, 2, 0).copy())
    rw = T(rwf[:hd].reshape(hd, kw, kw).transpose(1, 2, 0).copy())
    got = TWA.window_attn_core_twophase_plain(qkv, rh, rw)
    assert got.shape == (B * N, nh * hd)
    assert _rel(got, ref) <= 1e-5
    assert _rel(TWA.window_attn_core_plain(qkv, rh, rw), ref) <= 1e-5
    # the CPU wrapper, and the Function under the switch, run the plain B15
    calls = _calls(monkeypatch, TWA, "window_attn_core_twophase_plain")
    TWA.window_attn_core_twophase(qkv, rh, rw)
    TWA.window_attention(qkv, rh, rw)
    assert len(calls) == 2


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_twophase_plain_computes_b3(dt):
    """B15 computes B3's function with B3's rounding points: the two plain
    versions agree to float32 summation order, in either dtype (where the
    CPU matmul sums in another order a bf16 p or o may round the other way:
    two bf16 steps at max|o|)."""
    rng = np.random.default_rng(3)
    Bw, ws, nh, hd = 4, 7, 3, 80
    n, C = ws * ws, nh * hd
    qkv = T(rng.standard_normal((Bw * n, 3 * C)).astype(np.float32)).to(dt)
    rh = T((rng.standard_normal((ws, ws, hd)) * 0.2).astype(np.float32)).to(dt)
    rw = T((rng.standard_normal((ws, ws, hd)) * 0.2).astype(np.float32)).to(dt)
    got = TWA.window_attn_core_twophase_plain(qkv, rh, rw)
    want = TWA.window_attn_core_plain(qkv, rh, rw)
    assert got.dtype == dt
    assert _rel(got, want) <= (1e-6 if dt == torch.float32
                               else 2 * _bf16_step(want))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 80])
def test_twophase_smem_fits_a_block(dt, hd):
    """B15 launches B3's window core of its dtype (``window_core.cuh``,
    ``window_core_f32.cuh``), whose shared memory (``core_smem_bytes``,
    ``core_f32_smem_bytes``) fits one H100 block at SAM's 14x14 windows and
    at the largest window the wrapper takes (16x16), in both head dims; B15
    takes head dims 64 and 80."""
    assert hd in TWA._FWD_HEAD_DIMS
    smem = (TWA.core_smem_bytes if dt == torch.bfloat16
            else TWA.core_f32_smem_bytes)
    for ws in (14, 16):
        assert smem(ws * ws, ws, ws, hd) <= 232448
