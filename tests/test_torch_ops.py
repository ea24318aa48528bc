"""ullsam_tpu_torch.ops against ullsam_tpu.ops on the same numpy inputs.

Tolerances: f32 on the CPU, elementwise ops and small products -> 1e-5
(summation order only); bf16 GELU compares the two bf16 results within one
bf16 ulp at the input scale."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_close

from ullsam_tpu.core.config import InternLM2Config as JLLM
from ullsam_tpu.ops import attention as JA
from ullsam_tpu.ops import layers as JL
from ullsam_tpu.ops import resize as JR
from ullsam_tpu.ops import rope as JRope
from ullsam_tpu_torch.core.config import InternLM2Config as TLLM
from ullsam_tpu_torch.models.internlm2 import model as TM
from ullsam_tpu_torch.ops import attention as TA
from ullsam_tpu_torch.ops import layers as TL
from ullsam_tpu_torch.ops import resize as TR
from ullsam_tpu_torch.ops import rope as TRope

T = torch.from_numpy


@pytest.mark.parametrize("C", [8, 16, 64, 96])
def test_layer_norm_one_and_two_pass(C):
    """One-pass statistics from 32 channels up, two-pass below. The mean
    offset of 7 costs the one-pass form ~1e-5 to cancellation in
    E[x^2] - E[x]^2 on both sides, in different summation orders: 5e-5."""
    rng = np.random.default_rng(C)
    x = (rng.standard_normal((3, 5, C)) * 2 + 7).astype(np.float32)
    w = rng.standard_normal(C).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    ref = JL.layer_norm({"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                        jnp.asarray(x), eps=1e-6)
    got = TL.layer_norm(T(x), T(w), T(b), eps=1e-6)
    assert_close(got, ref, atol=5e-5, name=f"layer_norm C={C}")
    assert_close(TL.layer_norm_noparam(T(x), eps=1e-5),
                 JL.layer_norm_noparam(jnp.asarray(x), eps=1e-5), atol=5e-5)


def test_rms_norm_linear_swiglu_conv():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    assert_close(TL.rms_norm(T(x), T(w), eps=1e-5),
                 JL.rms_norm({"scale": jnp.asarray(w)}, jnp.asarray(x)),
                 atol=1e-5, name="rms_norm")
    k = rng.standard_normal((16, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    assert_close(TL.linear(T(x), T(k.T.copy()), T(bias)),
                 JL.linear({"kernel": jnp.asarray(k), "bias": jnp.asarray(bias)},
                           jnp.asarray(x)), atol=1e-5, name="linear")
    w1, w3 = (rng.standard_normal((16, 32)).astype(np.float32) * 0.2
              for _ in range(2))
    w2 = rng.standard_normal((32, 16)).astype(np.float32) * 0.2
    ref = JL.swiglu({"w1": {"kernel": jnp.asarray(w1)},
                     "w3": {"kernel": jnp.asarray(w3)},
                     "w2": {"kernel": jnp.asarray(w2)}}, jnp.asarray(x))
    ffn = TM.FeedForward(TLLM(hidden_size=16, intermediate_size=32),
                         device="cpu")
    for lin, k in ((ffn.w1, w1), (ffn.w3, w3), (ffn.w2, w2)):
        lin.weight.data.copy_(T(k.T.copy()))
    assert_close(ffn(T(x)), ref, atol=1e-5, name="swiglu")
    img = rng.standard_normal((2, 9, 9, 4)).astype(np.float32)
    ck = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)  # HWIO
    cb = rng.standard_normal(6).astype(np.float32)
    ref = JL.conv2d({"kernel": jnp.asarray(ck), "bias": jnp.asarray(cb)},
                    jnp.asarray(img), padding="SAME")
    got = TL.conv2d(T(img), T(ck.transpose(3, 2, 0, 1).copy()), T(cb),
                    padding=1)
    assert_close(got, ref, atol=1e-5, name="conv2d")


def test_gelu_dtype_switch():
    """Exact erf in f32, tanh form in bf16 (nn.GELU() alone is erf)."""
    x = np.linspace(-4, 4, 257).astype(np.float32)
    assert_close(TL.gelu(T(x)), JL.gelu(jnp.asarray(x)), atol=1e-6,
                 name="gelu f32")
    xb = T(x).to(torch.bfloat16)
    got = TL.gelu(xb).float()
    ref = np.asarray(JL.gelu(jnp.asarray(x, jnp.bfloat16)), np.float32)
    assert_close(got, ref, atol=2 ** -6, name="gelu bf16")
    erf = torch.nn.GELU()(xb).float()
    tanh = torch.nn.GELU(approximate="tanh")(xb).float()
    assert torch.equal(got, tanh)
    assert not torch.equal(erf, tanh)


def test_rel_pos_interp_golden(goldens):
    g = goldens("rel_pos_interp")
    rel = T(g["rel_pos"])
    assert_close(TA.get_rel_pos(4, 4, rel), g["out_44"], atol=2e-6,
                 name="rel_pos 4x4 interp")
    assert_close(TA.get_rel_pos(4, 8, rel), g["out_48"], atol=2e-6,
                 name="rel_pos 4x8 scaled")


def test_decomposed_rel_pos_and_attention():
    rng = np.random.default_rng(1)
    B, H, W, D = 3, 4, 6, 8
    q = rng.standard_normal((B, H * W, D)).astype(np.float32)
    k = rng.standard_normal((B, H * W, D)).astype(np.float32)
    v = rng.standard_normal((B, H * W, D)).astype(np.float32)
    rph = rng.standard_normal((5, D)).astype(np.float32)   # interpolated
    rpw = rng.standard_normal((2 * W - 1, D)).astype(np.float32)
    jr = JA.decomposed_rel_pos_terms(jnp.asarray(q), jnp.asarray(rph),
                                     jnp.asarray(rpw), (H, W), (H, W))
    tr = TA.decomposed_rel_pos_terms(T(q), T(rph), T(rpw), (H, W), (H, W))
    for a, b, n in zip(tr, jr, ("rel_h", "rel_w")):
        assert_close(a, b, atol=1e-5, name=n)
    jb = JA.decomposed_rel_pos_bias(jnp.asarray(q), jnp.asarray(rph),
                                    jnp.asarray(rpw), (H, W), (H, W))
    tb = TA.decomposed_rel_pos_bias(T(q), T(rph), T(rpw), (H, W), (H, W))
    assert_close(tb, jb, atol=1e-5, name="bias")
    assert_close(TA.attention(T(q), T(k), T(v), bias=tb),
                 JA.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              bias=jb), atol=1e-5, name="attention")


@pytest.mark.parametrize("scaling", [None, "linear", "dynamic"])
def test_rope(scaling):
    fields = dict(vocab_size=32, hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=8,
                  rope_theta=1e6, rope_scaling_type=scaling,
                  rope_scaling_factor=2.0)
    jcfg, tcfg = JLLM(**fields), TLLM(**fields)
    rng = np.random.default_rng(2)
    pos = np.arange(24)[None].repeat(2, 0)
    jc, js = JRope.rope_cos_sin(jcfg, jnp.asarray(pos), ntk_seq_len=24)
    tc, ts = TRope.rope_cos_sin(tcfg, T(pos), ntk_seq_len=24)
    assert_close(tc, jc, atol=1e-5, name="cos")
    assert_close(ts, js, atol=1e-5, name="sin")
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    jq, jk = JRope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, tk = TRope.apply_rope(T(q), T(k), tc, ts)
    assert_close(tq, jq, atol=1e-5, name="q")
    assert_close(tk, jk, atol=1e-5, name="k")


def test_rope_rejects_unknown_scaling():
    cfg = dataclasses.replace(TLLM(), rope_scaling_type="yarn")
    with pytest.raises(ValueError):
        TRope.rope_cos_sin(cfg, torch.arange(4))


def test_resize_and_postprocess_chain():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 16, 12)).astype(np.float32)
    got = TR.bilinear_resize(T(x), 40, 28)
    assert_close(got, JR.bilinear_resize(jnp.asarray(x), 40, 28), atol=1e-5)
    ref = torch.nn.functional.interpolate(T(x), size=(40, 28),
                                          mode="bilinear",
                                          align_corners=False)
    assert_close(got, ref, atol=1e-5, name="vs F.interpolate")
    m = rng.standard_normal((1, 2, 32, 32)).astype(np.float32)
    assert_close(TR.sam_postprocess_resize(T(m), 64, (48, 64), (30, 40)),
                 JR.sam_postprocess_resize(jnp.asarray(m), 64, (48, 64),
                                           (30, 40)), atol=1e-5)
