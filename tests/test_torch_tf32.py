"""The split-TF32 ("3xTF32") arithmetic of the float32 bodies of B8, B9,
B13, B3, B1, B10, B11, B2 and B14 (and of B15, which runs B3's core) on
the CPU (``ullsam_tpu_torch/ops/kernels/tf32.py``, the plain-torch
emulation of ``csrc/tf32.cuh``).

The kernels take each f32 product as a_hi b_hi + a_hi b_lo + a_lo b_hi on
TF32 values (hi = tf32(x), lo = tf32(x - hi), rounding to nearest with
ties away). Here the plain B8 and B9 dataflows run every product the
kernels put on the tensor cores through that emulation (``mm=``) and are
held to the JAX package's float32 kernels in interpret mode at 1e-5 of
max|ref| on every output, the parity that the JAX f32 path keeps
(flash_attention.py:837-839), at head dims 64 and 80; the same dataflow
with one TF32 pass misses that bar, so the test tells the two apart. So
are the LLM flash attention's plain B10 and B11 (``_llm_flash_impl`` and
``_llm_flash_bwd_impl``, head dims 64 and 128, a row with no valid key). So
are B2 and B14's (``_vit_flash_impl`` and ``_vit_flash_packed_impl``, head
dims 64 and 80). So are the forward kernels' plain versions: B13
(``ln_mlp_plain``, both products on the GEMM's f32 kind), B3
(``window_attn_core_plain``: the rel-pos terms, q k^T and p v on the f32
window core) and B1 (``window_attn_plain``: qkv, proj and B3's products).
So are B4 and B6's plain chains (``decode_masks_plain``,
``upscale_hypernet_stats_plain``: every GEMM product, as the float32 fused
decoder kernels and the GEMM's f32 kind take them) at
``tests/test_torch_decoder.py``'s case: within 1e-5 of max|out| of the
plain f32 chain, within its 1e-4 of the JAX XLA chain, and within 2x the
plain f32 chain's own error against a float64 run of it; one TF32 pass
misses both bounds. The card tests (``tests/test_torch_gpu.py``)
hold the kernels themselves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_decoder import M, M_LO, OFF, THR
from test_torch_decoder import HW as DEC_HW
from test_torch_decoder import case as decoder_case  # noqa: F401 (fixture)
from test_torch_train_kernels import (_b9_inputs, _flash_case, _pack_out,
                                      _pack_qkv, _pack_table, _rel, _unpack,
                                      _unpack_table, _window_core_case)

from ullsam_tpu.models.sam import image_encoder as JIE
from ullsam_tpu.ops.pallas import flash_attention as JFA
from ullsam_tpu.ops.pallas import vit_block as JVB
from ullsam_tpu_torch.ops import attention as TA
from ullsam_tpu_torch.ops.kernels import decoder as TD
from ullsam_tpu_torch.ops.kernels import flash_attention as TFA
from ullsam_tpu_torch.ops.kernels import llm_flash_attention as TLF
from ullsam_tpu_torch.ops.kernels import tf32 as T
from ullsam_tpu_torch.ops.kernels import vit_block as TVB
from ullsam_tpu_torch.ops.kernels import window_attention as TWA

TOL = 1e-5


def _mm_1xtf32(a, b):
    """One TF32 pass: what the tensor cores give without the split."""
    return torch.matmul(T.round_tf32(a), T.round_tf32(b))


def test_round_tf32_rounds_to_nearest_ties_away():
    """``round_tf32`` keeps 10 mantissa bits, to nearest with ties away from
    zero in both signs (``cvt.rna``), and hi + lo carries x to 2^-21."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + 1.5 * ulp, 1 + ulp / 2 - 2 ** -20,
                      -(1 + ulp / 2), 3.0, float("inf")])
    want = [1 + ulp, 1 + 2 * ulp, 1.0, -(1 + ulp), 3.0, float("inf")]
    assert T.round_tf32(x).tolist() == want
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10_000).astype(np.float32))
    hi, lo = T.split_tf32(v)
    bits = torch.cat([hi, lo]).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert float(((hi.double() + lo.double() - v.double()).abs()
                  / v.double().abs()).max()) <= 2.0 ** -21


def test_mm_3xtf32_is_f32_accurate():
    """Against float64, three TF32 passes err within 2x of an f32 matmul
    over a 4096-long sum; one pass errs over 100x more."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 4096)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((4096, 80)).astype(np.float32))
    ref = a.double() @ b.double()

    def err(c):
        return float((c.double() - ref).abs().max() / ref.abs().max())

    e32, e3 = err(a @ b), err(T.mm_3xtf32(a, b))
    assert e3 <= 2 * e32
    assert err(_mm_1xtf32(a, b)) > 100 * e32


@pytest.mark.parametrize("hd", [64, 80])
def test_b8_split_tf32_matches_tpu_kernel(hd):
    """Plain B8 with every tensor-core product in split TF32 against
    ``_vit_window_packed_bwd_impl`` (f32, interpret mode) on dqkv, drh and
    drw at SAM ViT-B's head dim (64) and ViT-H's (80): within 1e-5; one
    TF32 pass is not."""
    qkv, rh, rw, do, (nh, hd, ws, B) = _window_core_case(1, hd=hd)
    args = (jnp.asarray(_pack_qkv(qkv, nh, hd, B)),
            jnp.asarray(_pack_table(rh)), jnp.asarray(_pack_table(rw)))
    g = jnp.asarray(_pack_out(do, nh, hd, B))
    with pltpu.force_tpu_interpret_mode():
        ref = JFA._vit_window_packed_bwd_impl(*args, g, nh, hd, ws, ws)
    want = (_unpack(ref[0], 3, nh, hd), _unpack_table(ref[1], ws, hd),
            _unpack_table(ref[2], ws, hd))
    ins = [torch.from_numpy(a) for a in (qkv, rh, rw, do)]
    got = TWA.window_attn_core_bwd_plain(*ins, mm=T.mm_3xtf32)
    for name, a, b in zip(("dqkv", "drh", "drw"), got, want):
        assert _rel(a, b) < TOL, (name, _rel(a, b))
    one = TWA.window_attn_core_bwd_plain(*ins, mm=_mm_1xtf32)
    assert max(_rel(a, b) for a, b in zip(one, want)) > 10 * TOL


@pytest.mark.parametrize("D", [64, 80])
def test_b9_split_tf32_matches_tpu_kernel(D):
    """Plain B9 with its five products in split TF32 against
    ``_vit_flash_bwd_impl`` (f32, interpret mode, N = 256, blocks of 128) on
    dq, dk, dv, drel_h and drel_w at head dims 64 and 80: within 1e-5; one
    TF32 pass is not."""
    args, do = _flash_case(3, D=D)
    jargs = [jnp.asarray(a) for a in args]
    with pltpu.force_tpu_interpret_mode():
        o, lse = JFA._vit_flash_impl(*jargs, 128, 128)
        ref = JFA._vit_flash_bwd_impl(*jargs, o, lse, jnp.asarray(do),
                                      128, 128)
    t, g, lse_t, dd = _b9_inputs(args, do)
    got = TFA.vit_flash_attn_bwd_plain(*t, g, lse_t, dd, mm=T.mm_3xtf32)
    names = ("dq", "dk", "dv", "drel_h", "drel_w")
    for name, a, b in zip(names, got, ref):
        assert _rel(a, b) < TOL, (name, _rel(a, b))
    one = TFA.vit_flash_attn_bwd_plain(*t, g, lse_t, dd, mm=_mm_1xtf32)
    assert max(_rel(a, b) for a, b in zip(one, ref)) > 10 * TOL


@pytest.mark.parametrize("D", [64, 80])
def test_b2_b14_split_tf32_matches_tpu_kernel(D):
    """Plain B2 and B14 with their two products (q k^T, p v) in split TF32
    (the float32 kernel's arithmetic, csrc/vit_flash_attn.cu
    vit_flash_tf32) against the interpret-mode f32 ``_vit_flash_impl`` and
    ``_vit_flash_packed_impl`` (N = 256, blocks of 128; B14 as one image of
    the case's two heads, each head's D channels left-aligned in a 128-lane
    slot) on o and lse at head dims 64 and 80: within 1e-5; one TF32 pass is
    not. The port computes first, on copies of the numpy inputs."""
    args, _ = _flash_case(3, D=D)
    q, k, v, rel_h, rel_w = args
    nh, N = q.shape[0], q.shape[1]
    qkv = np.concatenate([x.transpose(1, 0, 2).reshape(1, N, nh * D)
                          for x in (q, k, v)], axis=-1)

    def run(mm):
        t = [torch.from_numpy(a.copy()) for a in args]
        o2, lse2 = TFA.vit_flash_attn_packed_plain(
            torch.from_numpy(qkv.copy()), t[3], t[4], nh, mm=mm)
        return [*TFA.vit_flash_attn_plain(*t, mm=mm),
                o2.reshape(N, nh, D).transpose(0, 1), lse2]

    got, one = run(T.mm_3xtf32), run(_mm_1xtf32)
    qkvp = np.pad(qkv.reshape(1, N, 3, nh, D),
                  ((0, 0),) * 4 + ((0, 128 - D),)).reshape(1, N, -1)
    with pltpu.force_tpu_interpret_mode():
        o, lse = JFA._vit_flash_impl(*(jnp.asarray(a) for a in args),
                                     128, 128)
        op, lsep = JFA._vit_flash_packed_impl(
            jnp.asarray(qkvp), jnp.asarray(rel_h), jnp.asarray(rel_w), nh,
            D, 128, 128)
    op = np.asarray(op).reshape(N, nh, 128)[..., :D].transpose(1, 0, 2)
    want = [np.asarray(o), np.asarray(lse)[..., 0], op,
            np.asarray(lsep)[..., 0]]
    names = ("B2 o", "B2 lse", "B14 o", "B14 lse")
    for name, a, b in zip(names, got, want):
        assert _rel(a, b) < TOL, (name, _rel(a, b))
    assert max(_rel(a, b) for a, b in zip(one, want)) > 10 * TOL


@pytest.mark.parametrize("D", [64, 128])
def test_b10_b11_split_tf32_matches_tpu_kernel(D):
    """Plain B10 and B11 with their products in split TF32 (the float32
    kernels' arithmetic, csrc/llm_f32.cuh) against the interpret-mode f32
    ``_llm_flash_impl`` (o; lse on the rows with a valid key) and
    ``_llm_flash_bwd_impl`` (dq, dk, dv) at B = 2, S = 300, 4 query heads
    over 2 kv heads, causal, with left padding, a second packed segment
    and ten query rows whose segment no key has: within 1e-5 at head dims
    64 and 128 (InternLM2's); one TF32 pass is not."""
    rng = np.random.RandomState(D)
    B, S, nh, nkv = 2, 300, 4, 2
    q, g = (rng.randn(B, S, nh, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, S, nkv, D).astype(np.float32) for _ in range(2))
    seg = np.ones((B, S), np.int32)
    seg[0, :50] = 0        # left padding
    seg[1, 200:] = 2       # packed second segment
    q_seg, kv_seg = seg.copy(), seg
    q_seg[0, 60:70] = 7    # no key has segment 7
    jq, jk, jv, jg, jqs, jks = map(jnp.asarray, (q, k, v, g, q_seg, kv_seg))
    with pltpu.force_tpu_interpret_mode():
        o, lse = JFA._llm_flash_impl(jq, jk, jv, jqs, jks, nkv, True, 128,
                                     128)
        grads = JFA._llm_flash_bwd_impl(jq, jk, jv, jqs, jks, o, lse, jg,
                                        nkv, True, 128, 128)
    lse = np.array(lse)[:, :, :S, 0]
    live = lse > TLF.NEG_INF / 2
    assert live.sum() == live.size - 10 * nh
    o = np.array(o)
    want = [o, lse[live], *(np.asarray(x) for x in grads)]
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    segs = (torch.from_numpy(q_seg), torch.from_numpy(kv_seg))
    dd = torch.from_numpy(np.einsum("bshd,bshd->bhs", g, o))

    def run(mm):
        out, lse_t = TLF.llm_flash_attn_plain(*ts, *segs, nkv, True, mm=mm)
        return [out, lse_t[torch.from_numpy(live)],
                *TLF.llm_flash_attn_bwd_plain(*ts, *segs, torch.from_numpy(g),
                                              torch.from_numpy(lse), dd, nkv,
                                              True, mm=mm)]

    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), run(T.mm_3xtf32),
                          want):
        assert _rel(a, b) < TOL, (name, _rel(a, b))
    one = run(_mm_1xtf32)
    assert max(_rel(a, b) for a, b in zip(one, want)) > 10 * TOL


@pytest.mark.parametrize("K", [1280, 5120])
def test_mm_3xtf32_at_the_gemm_depths(K):
    """Against float64, three TF32 passes err within 2x of an f32 matmul
    over the f32 GEMM's sums at ViT-H (K = 1280: qkv, proj, fc1; K =
    5120: fc2); one pass errs over 100x more."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((64, K)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, 128)) * K ** -0.5)
                         .astype(np.float32))
    ref = a.double() @ b.double()

    def err(c):
        return float((c.double() - ref).abs().max() / ref.abs().max())

    e32, e3 = err(a @ b), err(T.mm_3xtf32(a, b))
    assert e3 <= 2 * e32
    assert err(_mm_1xtf32(a, b)) > 100 * e32


# (nh, hd) of the forward tests: head dims 64 (SAM ViT-B / L) and 80
# (ViT-H), at widths whose C is a multiple of 128 (the JAX kernels' gate)
_WIDTHS = {64: (2, 64), 80: (8, 80)}


def _ln_mlp_case(C, seed=0, T_=300):
    rng = np.random.default_rng(seed)
    F = 4 * C

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return (r(T_, C, s=0.5), 1 + r(C, s=0.1), r(C, s=0.1),
            r(C, F, s=C ** -0.5), r(F, s=0.1), r(F, C, s=F ** -0.5),
            r(C, s=0.1))


@pytest.mark.parametrize("hd", [64, 80])
def test_b13_split_tf32_matches_tpu_kernel(monkeypatch, hd):
    """Plain B13 with both products in split TF32 against ``fused_ln_mlp``
    (f32, interpret mode, ``ULLSAM_FUSED_VIT_MLP=1``; 300 rows, C = nh *
    hd, F = 4C) within 1e-5 of max|out|; one TF32 pass is not."""
    nh, hd = _WIDTHS[hd]
    C = nh * hd
    x, lns, lnb, w1, b1, w2, b2 = _ln_mlp_case(C)
    monkeypatch.setattr("ullsam_tpu.ops.pallas.backend_ok", lambda: True)
    monkeypatch.setenv("ULLSAM_FUSED_VIT_MLP", "1")
    assert JVB.ln_mlp_supported(x.shape[0], C, 4 * C)
    ln = {"scale": jnp.asarray(lns), "bias": jnp.asarray(lnb)}
    mlp = {"fc1": {"kernel": jnp.asarray(w1), "bias": jnp.asarray(b1)},
           "fc2": {"kernel": jnp.asarray(w2), "bias": jnp.asarray(b2)}}
    with pltpu.force_tpu_interpret_mode():
        ref = JVB.fused_ln_mlp(jnp.asarray(x), ln, mlp, eps=1e-6)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (x, lns, lnb, w1.T, b1, w2.T, b2)]
    got = TVB.ln_mlp_plain(*args, eps=1e-6, mm=T.mm_3xtf32)
    assert got.shape == (x.shape[0], C)
    assert _rel(got, ref) < TOL, _rel(got, ref)
    one = TVB.ln_mlp_plain(*args, eps=1e-6, mm=_mm_1xtf32)
    assert _rel(one, ref) > 10 * TOL


@pytest.mark.parametrize("hd", [64, 80])
def test_b3_split_tf32_matches_tpu_kernel(hd):
    """Plain B3 with the rel-pos terms, q k^T and p v in split TF32 against
    ``vit_window_attention_packed`` (f32, interpret mode, the packed layout
    converted) within 1e-5 of max|o|; one TF32 pass is not."""
    qkv, rh, rw, _, (nh, hd, ws, B) = _window_core_case(2, hd=hd)
    args = (jnp.asarray(_pack_qkv(qkv, nh, hd, B)),
            jnp.asarray(_pack_table(rh)), jnp.asarray(_pack_table(rw)))
    with pltpu.force_tpu_interpret_mode():
        ref = JFA.vit_window_attention_packed(*args, nh, hd, ws, ws)
    want = _unpack(ref, 1, nh, hd)
    ins = [torch.from_numpy(a) for a in (qkv, rh, rw)]
    got = TWA.window_attn_core_plain(*ins, mm=T.mm_3xtf32)
    assert _rel(got, want) < TOL, _rel(got, want)
    one = TWA.window_attn_core_plain(*ins, mm=_mm_1xtf32)
    assert _rel(one, want) > 10 * TOL


def _window_block_case(nh, hd, seed=0):
    """A padded 10x10 grid (batch 2) in 4x4 windows: 18 windows, the pad
    tokens masked; C = nh * hd."""
    rng = np.random.default_rng(seed)
    C, ws, Bn, H, W = nh * hd, 4, 2, 10, 10

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    blk = {"norm1": {"scale": 1 + r(C, s=0.1), "bias": r(C, s=0.1)},
           "attn": {"qkv": {"kernel": r(C, 3 * C, s=C ** -0.5),
                            "bias": r(3 * C, s=0.1)},
                    "proj": {"kernel": r(C, C, s=C ** -0.5),
                             "bias": r(C, s=0.1)},
                    "rel_pos_h": r(2 * ws - 1, hd, s=0.3),
                    "rel_pos_w": r(2 * ws - 1, hd, s=0.3)}}
    xw, pad_hw = JIE.window_partition(jnp.asarray(r(Bn, H, W, C)), ws)
    xw = np.asarray(xw).reshape(-1, ws * ws, C)
    geom = dict(nwx=pad_hw[1] // ws, nwy=pad_hw[0] // ws, Hv=H, Wv=W,
                masked=True)
    return blk, xw, geom, ws


@pytest.mark.parametrize("hd", [64, 80])
def test_b1_split_tf32_matches_tpu_kernel(hd):
    """Plain B1 with qkv, proj and B3's products in split TF32 against
    ``fused_window_attn`` (f32, interpret mode) on a padded grid with
    masked pad tokens, within 1e-5 of max|out|; one TF32 pass is not."""
    nh, hd = _WIDTHS[hd]
    blk, xw, geom, ws = _window_block_case(nh, hd)
    jblk = {k: {kk: (jnp.asarray(vv) if not isinstance(vv, dict) else
                     {a: jnp.asarray(b) for a, b in vv.items()})
                for kk, vv in v.items()} for k, v in blk.items()}
    rhf, rwf = JIE._rel_tables_packed(jblk["attn"], ws, ws, hd, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = JVB.fused_window_attn(jnp.asarray(xw), jblk, rhf, rwf, nh=nh,
                                    hd=hd, kh=ws, kw=ws, eps=1e-6, **geom)
    a = blk["attn"]
    args = [torch.from_numpy(np.array(t)) for t in (
        xw, blk["norm1"]["scale"], blk["norm1"]["bias"], a["qkv"]["kernel"].T,
        a["qkv"]["bias"], a["proj"]["kernel"].T, a["proj"]["bias"])]
    args += [TA.get_rel_pos(ws, ws, torch.from_numpy(a[k])).contiguous()
             for k in ("rel_pos_h", "rel_pos_w")]
    kw = dict(num_heads=nh, eps=1e-6, **geom)
    got = TVB.window_attn_plain(*args, **kw, mm=T.mm_3xtf32)
    assert got.shape == xw.shape
    assert _rel(got, ref) < TOL, _rel(got, ref)
    one = TVB.window_attn_plain(*args, **kw, mm=_mm_1xtf32)
    assert _rel(one, ref) > 10 * TOL


def _f64(t):
    return ({k: v.double() for k, v in t.items()} if isinstance(t, dict)
            else t.double())


def _err64(x, ref64):
    return float((x.double() - ref64).abs().max() / ref64.abs().max())


@pytest.mark.parametrize("name", ["decode_masks", "upscale_hypernet_stats"])
def test_b4_b6_split_tf32_matches_f32_chain(decoder_case, name):
    """Plain B4 and B6 with every GEMM product in split TF32 (``mm=``, the
    float32 fused decoder kernels' arithmetic) at C = 256, a 32x32 grid and
    3 prompts: each float output within 1e-5 of max|out| of the plain f32
    chain and within 1e-4 of the JAX XLA chain, and against a float64 run
    of the plain chain within 2x the plain f32 chain's own error; one TF32
    pass misses the first and the last."""
    c = decoder_case
    if name == "decode_masks":
        fn, args = TD.decode_masks_plain, (c["w"], c["src"], c["pe"],
                                           c["tokens"])
        kw = dict(H=DEC_HW, W=DEC_HW, m_lo=M_LO, M=M, thr=THR, off=OFF,
                  **c["kw"])
        refs = (c["ref"]["q"], c["ref"]["logits"])
    else:
        fn = TD.upscale_hypernet_stats_plain
        args = (c["w"], torch.tensor(c["ref"]["keys"].reshape(
            -1, c["ref"]["keys"].shape[-1])), torch.tensor(c["ref"]["hyper"]))
        kw = dict(H=DEC_HW, W=DEC_HW, thr=THR, off=OFF)
        refs = (c["ref"]["logits"],)
    n = len(refs)
    f32 = fn(*args, **kw)[:n]
    tf3 = fn(*args, **kw, mm=T.mm_3xtf32)[:n]
    one = fn(*args, **kw, mm=_mm_1xtf32)[:n]
    r64 = fn(*(_f64(a) for a in args), **kw)[:n]
    for i, (a, b, o, r, x) in enumerate(zip(tf3, f32, one, r64, refs)):
        assert r.dtype == torch.float64 and a.shape == b.shape
        assert _rel(a, b) < TOL, (i, _rel(a, b))
        np.testing.assert_allclose(a.numpy(), x, atol=1e-4, err_msg=str(i))
        e3, e32, e1 = _err64(a, r), _err64(b, r), _err64(o, r)
        assert e3 <= 2 * e32, (i, e3, e32)
        assert _rel(o, b) > TOL and e1 > 2 * e32, (i, _rel(o, b), e1, e32)
