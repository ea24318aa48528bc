"""The port's mask-decoder kernels B4-B7 (``ops/kernels/decoder.py``), as
their plain versions on the CPU, against the JAX package's XLA chain at SAM's
production decoder widths (C=256, Cd=128, 8 heads, MLP 2048, M=3 of 4 mask
tokens, T=7 tokens) on a 32x32 grid with 3 prompts, in float32.

Tolerances: 1e-4 absolute against the XLA chain (float32 on both sides, only
the summation order differs; values are O(1) after each LayerNorm); the
statistics exactly, against the JAX statistics of the port's own logits (a
logit within rounding of the threshold may fall either way in two
implementations); 2% of max|logit| against the interpret-mode Pallas kernel,
the bound of the JAX package's own test (its GELU is the tanh form)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_close, jax_init, jax_params_to_numpy

from ullsam_tpu.core import config as JC
from ullsam_tpu.inference import amg as JA
from ullsam_tpu.models.sam import mask_decoder as JMD
from ullsam_tpu.models.sam.two_way_transformer import (
    two_way_transformer_apply)
from ullsam_tpu.ops import layers as JL
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.models.sam.mask_decoder import (MaskDecoder,
                                                      stats_from_kernel)
from ullsam_tpu_torch.ops.kernels import decoder as D

B, T, HW = 3, 7, 32
N = HW * HW
M_LO, M = 1, 3
THR, OFF = 0.0, 1.0


@pytest.fixture(scope="module")
def case():
    """JAX decoder params, the port's packed weights, inputs, and the XLA
    chain's outputs."""
    jcfg, tcfg = JC.MaskDecoderConfig(), TC.MaskDecoderConfig()
    p = jax_params_to_numpy(jax_init(JMD.mask_decoder_init, 0, jcfg))
    md = MaskDecoder(tcfg, device="cpu")
    X.load_reference_state_dict(md, X.mask_decoder_arrays(p, tcfg),
                                "mask_decoder.")
    rng = np.random.default_rng(0)
    C = tcfg.transformer_dim
    emb = (rng.standard_normal((1, HW, HW, C)) * 0.5).astype(np.float32)
    pe = (rng.standard_normal((1, HW, HW, C)) * 0.5).astype(np.float32)
    toks = (rng.standard_normal((B, T, C)) * 0.5).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    hs, keys = jax.jit(two_way_transformer_apply, static_argnums=1)(
        jp["transformer"], jcfg, emb, pe, toks)
    hyper = jnp.stack([JL.mlp_stack(jp["hyper_mlps"][i], hs[:, 1 + i])
                       for i in range(M_LO, M_LO + M)], axis=1)
    cols = JMD._upscale_hypernet_cols(jp["upscale"], hyper, keys)
    ref = {"q": np.asarray(hs), "keys": np.asarray(keys),
           "hyper": np.asarray(hyper),
           "logits": np.asarray(JMD.cols_to_spatial(cols, M, HW, HW))}
    kw = dict(heads=tcfg.transformer_num_heads, eps=tcfg.ln_eps)
    return dict(p=jp, jcfg=jcfg, w=D.pack_weights(md, torch.float32),
                src=torch.from_numpy(emb.reshape(N, C)),
                pe=torch.from_numpy(pe.reshape(N, C)),
                tokens=torch.from_numpy(toks), ref=ref, kw=kw,
                np=(emb, pe, toks))


def _assert_stats_of(logits, counts, rowany, colany):
    """Stats equal the JAX package's statistics of these logits."""
    x = jnp.asarray(logits.numpy())
    stab_ref = np.asarray(JA.calculate_stability_score(x, THR, OFF))
    box_ref = np.asarray(JA.batched_mask_to_box(x > THR))
    stab, boxes = stats_from_kernel(counts, rowany, colany)
    np.testing.assert_array_equal(stab.numpy(), stab_ref)
    np.testing.assert_array_equal(boxes.numpy(), box_ref)


def test_b5_two_way_transformer_plain_matches_xla(case):
    q, keys = D.two_way_transformer(case["w"], case["src"], case["pe"],
                                    case["tokens"], **case["kw"])
    assert q.shape == (B, T, 256) and keys.shape == (B * N, 256)
    assert_close(q, case["ref"]["q"], atol=1e-4, name="q")
    assert_close(keys.view(B, N, -1), case["ref"]["keys"], atol=1e-4,
                 name="keys")


@pytest.mark.parametrize("stats", [False, True], ids=["b7", "b6"])
def test_b7_b6_upscale_hypernet_plain_matches_xla(case, stats):
    keys = torch.tensor(case["ref"]["keys"].reshape(B * N, -1))
    hyper = torch.tensor(case["ref"]["hyper"])
    if stats:
        logits, *st = D.upscale_hypernet_stats(
            case["w"], keys, hyper, H=HW, W=HW, thr=THR, off=OFF)
        _assert_stats_of(logits, *st)
    else:
        logits = D.upscale_hypernet(case["w"], keys, hyper, H=HW, W=HW)
    assert logits.shape == (B, M, 4 * HW, 4 * HW)
    assert_close(logits, case["ref"]["logits"], atol=1e-4, name="logits")


def test_b4_decode_masks_plain_matches_xla(case):
    q, logits, *st = D.decode_masks(
        case["w"], case["src"], case["pe"], case["tokens"], H=HW, W=HW,
        m_lo=M_LO, M=M, thr=THR, off=OFF, **case["kw"])
    assert_close(q, case["ref"]["q"], atol=1e-4, name="q")
    assert_close(logits, case["ref"]["logits"], atol=1e-4, name="logits")
    _assert_stats_of(logits, *st)


def test_b4_decode_masks_plain_matches_pallas_interpret(case):
    """The interpret-mode Pallas megakernel on the same weights and inputs,
    as tests/test_kernels.py runs it."""
    from ullsam_tpu.ops.pallas import decoder as PD
    jp, jcfg = case["p"], case["jcfg"]
    emb, pe, toks = case["np"]
    C = jcfg.transformer_dim
    m_idx = range(M_LO, M_LO + M)
    jq, cols, *_ = PD.fused_decode_masks(
        jp["transformer"], JMD._upscale_weight_views(jp["upscale"]),
        PD.pack_hyper_mlps([jp["hyper_mlps"][i] for i in m_idx],
                           dtype=jnp.float32),
        jnp.asarray(emb.reshape(1, N, C)), jnp.asarray(pe.reshape(1, N, C)),
        jnp.asarray(toks), heads=jcfg.transformer_num_heads,
        mlp_dim=jcfg.transformer_mlp_dim, eps=jcfg.ln_eps, W=HW, nm=M,
        thr=THR, off=OFF, m_lo=M_LO, interpret=True)
    q, logits, *_ = D.decode_masks_plain(
        case["w"], case["src"], case["pe"], case["tokens"], H=HW, W=HW,
        m_lo=M_LO, M=M, thr=THR, off=OFF, **case["kw"])
    assert_close(q, np.asarray(jq), atol=1e-4, name="q")
    spatial = np.asarray(JMD.cols_to_spatial(cols, M, HW, HW))
    err = np.abs(logits.numpy() - spatial).max()
    assert err <= 0.02 * np.abs(spatial).max(), err


@pytest.mark.parametrize("bad", ["width", "tokens", "masks", "dtype"])
def test_decoder_wrappers_raise_on_unsupported_shapes(case, bad):
    """Off the CPU every wrapper checks the shapes its kernels take before
    anything runs; ``meta`` tensors stand for a card here."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, device="meta", dtype=dtype)

    w = {k: v.to("meta") for k, v in case["w"].items()}
    C = 256 if bad != "width" else 192
    T_ = 17 if bad == "tokens" else T
    M_ = 5 if bad == "masks" else M
    dt = torch.float16 if bad == "dtype" else torch.float32
    src, pe = meta(N, C, dtype=dt), meta(N, C)
    toks = meta(B, T_, C)
    keys, hyper = meta(B * N, C, dtype=dt), meta(B, M_, C // 8)
    kw = dict(case["kw"])
    calls = [lambda: D.decode_masks(w, src, pe, toks, H=HW, W=HW, m_lo=0,
                                    M=M_, thr=THR, off=OFF, **kw)]
    if bad != "masks":
        calls.append(lambda: D.two_way_transformer(w, src, pe, toks, **kw))
    if bad != "tokens":
        calls += [
            lambda: D.upscale_hypernet(w, keys, hyper, H=HW, W=HW),
            lambda: D.upscale_hypernet_stats(w, keys, hyper, H=HW, W=HW,
                                             thr=THR, off=OFF)]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported (shape|upscale "
                           "shape|M=|dtype)"):
            call()
