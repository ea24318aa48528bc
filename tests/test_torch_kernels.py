"""The plain versions of the port's kernels against the TPU kernels they
replace, run as the JAX package's own tests run them on the CPU (Pallas
interpret mode) and against the JAX package's XLA formulations; plus the
wrappers' CPU dispatch.

B1 ``window_attn``  <- vit_block.py ``_window_attn_kernel``
B2 ``vit_flash_attn`` <- flash_attention.py ``_vit_kernel``

Tolerances: f32 -> 2e-5 (the same math in another summation order),
except B2 against its TPU kernel -> 1e-4: that kernel rebuilds the f32
bias from bf16 hi + lo parts (``_bias_select``), exact to ~2^-16 of |bias|
(up to ~2.5 here), so a logit may move by ~4e-5 and o by up to ~1e-4;
bf16 B1 -> 2e-2 of the output scale (the rounding points are the same, but
different sums can round a value to the neighbouring bf16 step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_helpers import assert_close, to_np

from ullsam_tpu.models.sam import image_encoder as JIE
from ullsam_tpu.ops.pallas import flash_attention as JFA
from ullsam_tpu.ops.pallas import vit_block as JVB
from ullsam_tpu_torch.ops import attention as TA
from ullsam_tpu_torch.ops.kernels import flash_attention as TFA
from ullsam_tpu_torch.ops.kernels import vit_block as TVB


def _window_case(dtype_np, seed=0):
    """Padded 10x10 grid (batch 2) in 4x4 windows -> 12x12, 18 windows;
    C = 128, 2 heads of 64."""
    rng = np.random.default_rng(seed)
    C, nh, ws, B, H, W = 128, 2, 4, 2, 10, 10
    hd = C // nh

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    blk = {
        "norm1": {"scale": 1 + r(C, s=0.1), "bias": r(C, s=0.1)},
        "attn": {"qkv": {"kernel": r(C, 3 * C, s=C ** -0.5),
                         "bias": r(3 * C, s=0.1)},
                 "proj": {"kernel": r(C, C, s=C ** -0.5), "bias": r(C, s=0.1)},
                 "rel_pos_h": r(2 * ws - 1, hd, s=0.3),
                 "rel_pos_w": r(2 * ws - 1, hd, s=0.3)},
    }
    x = r(B, H, W, C)
    xw, pad_hw = JIE.window_partition(jnp.asarray(x), ws)
    xw = np.asarray(xw).reshape(-1, ws * ws, C).astype(dtype_np)
    geom = dict(nwx=pad_hw[1] // ws, nwy=pad_hw[0] // ws, Hv=H, Wv=W,
                masked=True)
    return blk, xw, geom, nh, hd, ws


def _window_torch_args(blk, xw, ws, dtype):
    a = blk["attn"]
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype) for k, v in {
        "x": np.asarray(xw, np.float32), "lnw": blk["norm1"]["scale"],
        "lnb": blk["norm1"]["bias"], "qkvw": a["qkv"]["kernel"].T,
        "qkvb": a["qkv"]["bias"], "projw": a["proj"]["kernel"].T,
        "projb": a["proj"]["bias"]}.items()}
    rh = TA.get_rel_pos(ws, ws, torch.from_numpy(a["rel_pos_h"])).to(dtype)
    rw = TA.get_rel_pos(ws, ws, torch.from_numpy(a["rel_pos_w"])).to(dtype)
    return (t["x"], t["lnw"], t["lnb"], t["qkvw"], t["qkvb"], t["projw"],
            t["projb"], rh.contiguous(), rw.contiguous())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_window_attn_plain_matches_tpu_kernel(dt):
    """B1 plain vs ``_window_attn_call`` in interpret mode, on a padded
    grid with masked pad tokens; the JAX side takes the packed layout
    (``pack_window_attn_weights`` / ``_rel_tables_packed``)."""
    jdt = jnp.float32 if dt == "float32" else jnp.bfloat16
    tdt = torch.float32 if dt == "float32" else torch.bfloat16
    blk, xw, geom, nh, hd, ws = _window_case(np.float32)
    jblk = {k: {kk: (jnp.asarray(vv) if not isinstance(vv, dict) else
                     {a: jnp.asarray(b) for a, b in vv.items()})
                for kk, vv in v.items()} for k, v in blk.items()}
    qkvw, bqkv, wo, bo = JVB.pack_window_attn_weights(jblk, nh, hd, jdt)
    rhf, rwf = JIE._rel_tables_packed(jblk["attn"], ws, ws, hd, jdt)
    with pltpu.force_tpu_interpret_mode():
        ref = JVB._window_attn_call(
            jnp.asarray(xw, jdt), jblk["norm1"]["scale"][None],
            jblk["norm1"]["bias"][None], qkvw, bqkv, wo, bo, rhf, rwf, 1, nh,
            hd, ws, ws, 1e-6, geom["nwx"], geom["nwy"], geom["Hv"],
            geom["Wv"], True)
    args = _window_torch_args(blk, xw, ws, tdt)
    got = TVB.window_attn_plain(*args, num_heads=nh, eps=1e-6, **geom)
    ref = np.asarray(ref, np.float32)
    tol = 2e-5 if dt == "float32" else 2e-2 * np.abs(ref).max()
    assert_close(got, ref, atol=tol, name=f"B1 plain vs TPU kernel {dt}")


def test_window_attn_plain_matches_xla_block():
    """B1 plain vs the JAX package's XLA window block (LN, pad mask, qkv,
    rel-pos attention, proj, residual) on the same padded grid."""
    blk, xw, geom, nh, hd, ws = _window_case(np.float32, seed=1)
    a = blk["attn"]
    mask = TVB.window_pad_mask(xw.shape[0], ws * ws, ws, ws, geom["nwx"],
                               geom["nwy"], geom["Hv"], geom["Wv"], "cpu")
    ref = JVB._window_attn_xla(
        jnp.asarray(xw), jnp.asarray(blk["norm1"]["scale"])[None],
        jnp.asarray(blk["norm1"]["bias"])[None],
        *JVB.pack_window_attn_weights(
            {"attn": {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                          if isinstance(v, dict) else jnp.asarray(v))
                      for k, v in a.items()}}, nh, hd, jnp.float32),
        *JIE._rel_tables_packed({k: jnp.asarray(v) for k, v in a.items()
                                 if k.startswith("rel")}, ws, ws, hd,
                                jnp.float32),
        jnp.asarray(to_np(mask)), nh, hd, ws, ws, 1e-6)
    got = TVB.window_attn_plain(*_window_torch_args(blk, xw, ws,
                                                    torch.float32),
                                num_heads=nh, eps=1e-6, **geom)
    assert_close(got, ref, atol=2e-5, name="B1 plain vs XLA chain")


def _flash_case(seed=1):
    rng = np.random.default_rng(seed)
    B, KH, KW, D = 2, 16, 16, 64
    N = KH * KW
    qkv = [rng.standard_normal((B, N, D)).astype(np.float32)
           for _ in range(3)]
    rel = [(rng.standard_normal((B, N, K)) * 0.3).astype(np.float32)
           for K in (KH, KW)]
    return qkv + rel


def test_vit_flash_attn_plain_matches_tpu_kernel_and_xla():
    """B2 plain vs ``vit_flash_attention(..., 128, 128)`` in interpret mode
    (output and row logsumexp) and vs ``_vit_attention_xla``."""
    args = _flash_case()
    jargs = [jnp.asarray(a) for a in args]
    with pltpu.force_tpu_interpret_mode():
        ref_o, ref_lse = JFA._vit_flash_impl(*jargs, 128, 128)
    xla = JFA._vit_attention_xla(*jargs)
    o, lse = TFA.vit_flash_attn_plain(*(torch.from_numpy(a) for a in args))
    assert_close(o, ref_o, atol=1e-4, name="B2 o vs TPU kernel")
    assert_close(lse, np.asarray(ref_lse)[..., 0], atol=1e-4,
                 name="B2 lse vs TPU kernel")
    assert_close(o, xla, atol=2e-5, name="B2 o vs XLA")


def test_vit_flash_plain_computes_float64_in_float64():
    """Plain B2 and B14 on float64 inputs compute in float64 throughout (q
    * D^-1/2 included): the result is not the float32 call's on the same
    values, and within 1e-12 of max|ref| of a float64 ``torch.softmax``
    reference (o and lse)."""
    args = [torch.from_numpy(a).double() for a in _flash_case(seed=4)]
    q, k, v, rel_h, rel_w = args
    (BH, N, D), nh = q.shape, 2
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(BH, N, N)
    logits = q @ k.transpose(-1, -2) * D ** -0.5 + bias
    ref = (torch.softmax(logits, -1) @ v, torch.logsumexp(logits, -1))
    qkv = torch.cat([t.reshape(1, nh * N, D).reshape(1, nh, N, D)
                     .transpose(1, 2).reshape(1, N, nh * D)
                     for t in (q, k, v)], -1)
    for name, plain, a in (
            ("B2", TFA.vit_flash_attn_plain, (q, k, v, rel_h, rel_w)),
            ("B14", lambda *a: TFA.vit_flash_attn_packed_plain(*a, nh),
             (qkv, rel_h, rel_w))):
        got = plain(*a)
        f32 = plain(*(t.float() for t in a))
        if name == "B14":
            got = (got[0].reshape(N, nh, D).transpose(0, 1), got[1])
            f32 = (f32[0].reshape(N, nh, D).transpose(0, 1), f32[1])
        for x, y, r in zip(got, f32, ref):
            assert x.dtype == torch.float64
            assert not torch.equal(x, y.double()), name
            assert float((x - r).abs().max() / r.abs().max()) <= 1e-12, name


def test_wrappers_run_plain_on_cpu_without_launching():
    blk, xw, geom, nh, hd, ws = _window_case(np.float32, seed=2)
    args = _window_torch_args(blk, xw, ws, torch.float32)
    before = TVB.window_attn.launches
    got = TVB.window_attn(*args, num_heads=nh, eps=1e-6, **geom)
    ref = TVB.window_attn_plain(*args, num_heads=nh, eps=1e-6, **geom)
    assert torch.equal(got, ref)
    assert TVB.window_attn.launches == before
    fargs = [torch.from_numpy(a) for a in _flash_case(seed=3)]
    before = TFA.vit_flash_attn.launches
    for a, b in zip(TFA.vit_flash_attn(*fargs),
                    TFA.vit_flash_attn_plain(*fargs)):
        assert torch.equal(a, b)
    assert TFA.vit_flash_attn.launches == before


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card raises; it
    never silently takes the plain path."""
    blk, xw, geom, nh, hd, ws = _window_case(np.float32, seed=4)
    meta = [None if t is None else t.to("meta")
            for t in _window_torch_args(blk, xw, ws, torch.float32)]
    with pytest.raises(ValueError):
        TVB.window_attn(*meta, num_heads=nh, eps=1e-6, **geom)
    fmeta = [torch.from_numpy(a).to("meta") for a in _flash_case(seed=5)]
    with pytest.raises(ValueError):
        TFA.vit_flash_attn(*fmeta)
