"""Caption generation in the port against ullsam_tpu: the KV-cache prefill
and decode steps, greedy ``generate`` (and the ``internlm2_tiny`` golden's
tokens), the logit warpers and seeded sampling, and the whole slice,
``caption_ids`` on the tiny uLLSAM with an image, unquantized and with the
int8 LLM, on weights carried by ``fusion_state_dict_from_jax``.

Tolerances, f32 on the CPU (only the summation order differs): logits and
cache entries 1e-5; tokens and lengths equal; the warpers' -inf pattern
equal and their finite values 1e-5."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (assert_close, jax_init, jax_params_to_numpy,
                                tiny_fusion_config)

from ullsam_tpu.core import config as JC
from ullsam_tpu.models.internlm2 import model as JM
from ullsam_tpu.models.internlm2 import quant as JQ
from ullsam_tpu.models.ullsam import fusion as JF
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.models.internlm2 import generate as TG
from ullsam_tpu_torch.models.internlm2 import model as TM
from ullsam_tpu_torch.models.internlm2 import quant as TQ
from ullsam_tpu_torch.models.ullsam import chat as TChat
from ullsam_tpu_torch.models.ullsam import fusion as TF

T = torch.from_numpy
# the package __init__s re-export functions named ``generate`` and ``chat``
JG = importlib.import_module("ullsam_tpu.models.internlm2.generate")
JChat = importlib.import_module("ullsam_tpu.models.ullsam.chat")
FIELDS = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=32, bias=False,
              rope_theta=10000.0, pad_token_id=0, bos_token_id=1,
              eos_token_id=2)
GOLDEN = TC.InternLM2Config(**FIELDS)


def _llm(fields):
    jcfg, cfg = JC.InternLM2Config(**fields), TC.InternLM2Config(**fields)
    p = jax_params_to_numpy(jax_init(JM.internlm2_init, 0, jcfg))
    lm = TM.InternLM2ForCausalLM(cfg, device="cpu")
    X.load_reference_state_dict(lm, X.internlm2_arrays(p, cfg))
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, p), lm.eval()


def _left_padded(rng, B, S, pads, vocab=128):
    ids = rng.integers(3, vocab, (B, S))
    mask = np.ones((B, S), np.int64)
    for b, n in enumerate(pads):
        mask[b, :n] = 0
        ids[b, :n] = 0
    return ids, mask


@pytest.mark.parametrize("rope", [
    {},                                          # max_len within 32
    {"rope_scaling_type": "dynamic", "rope_scaling_factor": 2.0,
     "max_position_embeddings": 8}])             # max_len 14 > 8: NTK on
def test_cache_steps_match_jax(rope):
    """internlm2_prefill then 4 x internlm2_decode_step, left-padded B = 2,
    f32: logits 1e-5, cache k / v 1e-5 and mask equal in the written
    slots, the write index as JAX's. With dynamic NTK and max_len above
    max_position_embeddings, a step that scaled by S instead of max_len
    would fail."""
    jcfg, cfg, jp, lm = _llm(dict(FIELDS, **rope))
    rng = np.random.default_rng(0)
    ids, mask = _left_padded(rng, 2, 6, (0, 2))
    steps = rng.integers(3, 128, (4, 2))
    max_len = 14
    jc = JM.init_cache(jcfg, 2, max_len, dtype=jnp.float32)
    jout, jc = JM.internlm2_prefill(jp, jcfg, JM.embed_tokens(
        jp, jnp.asarray(ids)), jnp.asarray(mask), jc)
    with torch.no_grad():
        tc = TM.init_cache(cfg, 2, max_len, dtype=torch.float32)
        tout, tc = TM.internlm2_prefill(lm, cfg, TM.embed_tokens(lm, T(ids)),
                                        T(mask), tc)
    valid = mask.astype(bool)
    assert tout["logits"].shape == (2, 6, 128)
    assert_close(tout["logits"].numpy()[valid],
                 np.asarray(jout["logits"])[valid], atol=1e-5,
                 name="prefill logits")
    for t in range(4):
        jl, jc = JM.internlm2_decode_step(jp, jcfg, JM.embed_tokens(
            jp, jnp.asarray(steps[t]))[:, None], jc)
        with torch.no_grad():
            tl, tc = TM.internlm2_decode_step(
                lm, cfg, TM.embed_tokens(lm, T(steps[t]))[:, None], tc)
        assert_close(tl, jl, atol=1e-5, name=f"decode step {t}")
    assert tc.index == int(jc.index) == 10
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    written = np.asarray(jc.mask).astype(bool)
    for name, a, b in (("k", tc.k, jc.k), ("v", tc.v, jc.v)):
        assert_close(a.numpy()[:, written], np.asarray(b)[:, written],
                     atol=1e-5, name=name)


def test_prefill_matches_cacheless_forward():
    """Without NTK scaling the cached prefill's logits are the cache-less
    forward's on the valid rows (the cache only adds masked slots)."""
    _, cfg, _, lm = _llm(FIELDS)
    ids, mask = _left_padded(np.random.default_rng(1), 2, 9, (3, 0))
    with torch.no_grad():
        full = TM.internlm2_forward(lm, cfg, input_ids=T(ids),
                                    attention_mask=T(mask))
        out, cache = TM.internlm2_prefill(
            lm, cfg, TM.embed_tokens(lm, T(ids)), T(mask),
            TM.init_cache(cfg, 2, 16, dtype=torch.float32))
    valid = mask.astype(bool)
    assert_close(out["logits"].numpy()[valid], full["logits"].numpy()[valid],
                 atol=1e-5)
    assert cache.index == 9 and cache.k.shape == (2, 2, 16, 2, 16)


def test_gqa_attention_takes_per_query_mask():
    """gqa_attention with the [B, S, T] additive causal-and-padding mask of
    ``causal_mask`` equals the [B, 1, T] key mask with causal=True."""
    rng = np.random.default_rng(2)
    B, S, nh, nkv, hd = 2, 7, 4, 2, 16
    q, k, v = (T(rng.standard_normal((B, S, h, hd)).astype(np.float32))
               for h in (nh, nkv, nkv))
    att = torch.ones(B, S, dtype=torch.int32)
    att[1, :3] = 0
    kmask = torch.where(att.bool(), 0.0, TM.NEG_INF)[:, None]
    ref = TM.gqa_attention(q, k, v, kmask, GOLDEN, causal=True)
    got = TM.gqa_attention(q, k, v, TM.causal_mask(att, S, S), GOLDEN)
    assert_close(got[att.bool()], ref[att.bool()], atol=1e-6)


def test_generate_greedy_matches_jax():
    jcfg, cfg, jp, lm = _llm(FIELDS)
    ids, mask = _left_padded(np.random.default_rng(3), 3, 8, (0, 3, 5))
    kw = dict(max_new_tokens=12, eos_token_id=2, pad_token_id=0)
    toks_j, lens_j = JG.generate(jp, jcfg, JG.GenerationConfig(**kw),
                                 JM.embed_tokens(jp, jnp.asarray(ids)),
                                 jnp.asarray(mask))
    toks_t, lens_t = TG.generate(lm, cfg, TG.GenerationConfig(**kw),
                                 TM.embed_tokens(lm, T(ids)), T(mask))
    assert toks_t.dtype == torch.int32 and toks_t.shape == (3, 12)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))


def test_generate_matches_golden(goldens):
    """The torch reference's greedy tokens (``gen_new``) up to each row's
    EOS, left-padded prompts (``tests/test_internlm2_parity.py:62-75``)."""
    g = goldens("internlm2_tiny")
    lm = X.load_reference_state_dict(
        TM.InternLM2ForCausalLM(GOLDEN, device="cpu"), g).eval()
    gen = TG.GenerationConfig(max_new_tokens=8, eos_token_id=2,
                              pad_token_id=0)
    toks, lens = TG.generate(lm, GOLDEN, gen,
                             TM.embed_tokens(lm, T(g["left_ids"])),
                             T(g["left_attn"]))
    for b in range(g["gen_new"].shape[0]):
        n = int(lens[b])
        np.testing.assert_array_equal(toks[b, :n].numpy(),
                                      g["gen_new"][b, :n], err_msg=f"row {b}")


WARPERS = [dict(do_sample=True, temperature=0.7, top_k=50, top_p=0.9),
           dict(do_sample=True, top_k=5), dict(do_sample=True, top_p=0.5),
           dict(do_sample=False)]


@pytest.mark.parametrize("kw", WARPERS)
def test_apply_warpers_matches_jax(kw):
    logits = np.random.RandomState(0).randn(4, 128).astype(np.float32) * 3
    ref = np.asarray(JG.apply_warpers(jnp.asarray(logits),
                                      JG.GenerationConfig(**kw)))
    got = TG.apply_warpers(T(logits), TG.GenerationConfig(**kw)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    kept = np.isfinite(ref)
    np.testing.assert_allclose(got[kept], ref[kept], atol=1e-5)


@pytest.mark.parametrize("kw", WARPERS)
def test_sampling_is_seeded_and_stays_in_kept_set(kw):
    """Draws cannot match JAX's across frameworks: a seeded Generator
    repeats its draw, every draw lies in the warped distribution's support,
    and greedy is the argmax."""
    logits = T(np.random.RandomState(1).randn(4, 128).astype(np.float32) * 3)
    gen = TG.GenerationConfig(**kw)
    kept = torch.isfinite(TG.apply_warpers(logits, gen))
    draws = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(7)
        draws.append(torch.stack([TG.sample_token(logits, gen, g)
                                  for _ in range(16)]))
    assert torch.equal(draws[0], draws[1])
    assert bool(kept.gather(1, draws[0].t()).all())
    if not gen.do_sample:
        assert bool((draws[0] == logits.argmax(-1)).all())


def test_left_pad_matches_jax_bucketing():
    """``left_pad`` is ``_tokenize_left_padded`` after the tokenizer."""
    rows = [[5, 6, 7], list(range(3, 133)), [9]]

    class Tok:
        pad_token_id = 2

        def encode_batch(self, prompts, pad_side):
            n = max(len(r) for r in prompts)
            return ([[2] * (n - len(r)) + r for r in prompts],
                    [[0] * (n - len(r)) + [1] * len(r) for r in prompts])

    want_ids, want_mask = JChat._tokenize_left_padded(Tok(), rows)
    ids, mask = TChat.left_pad(rows, 2)
    assert ids.shape == (3, 256)
    np.testing.assert_array_equal(ids, np.asarray(want_ids))
    np.testing.assert_array_equal(mask, np.asarray(want_mask))


@pytest.mark.parametrize("quantized", [False, True])
def test_caption_ids_matches_jax(quantized):
    """The whole slice on the tiny uLLSAM, f32: two left-padded prompts with
    the image run, one image, ``caption_ids`` against JAX
    ``_embeds_with_image`` + ``generate``; with ``quantized`` both LLMs are
    int8 (each package's own ``quantize_llm_int8``). Tokens and lengths
    equal."""
    jcfg, tcfg = tiny_fusion_config(JC), tiny_fusion_config(TC)
    rng = np.random.default_rng(0)
    p = jax_params_to_numpy(jax_init(JF.fusion_init, 0, jcfg), rng)
    model = TF.ULLSAM(tcfg, device="cpu")
    model.load_state_dict(X.fusion_state_dict_from_jax(p, tcfg))
    model.eval()
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    if quantized:
        jp = dict(jp, llm=JQ.quantize_llm_int8(jp["llm"]))
        TQ.quantize_llm_int8(model.fusion.language_model)
    n = jcfg.num_image_token
    rows = []
    for extra in (5, 9):
        r = [1, 3] + [jcfg.img_context_token_id] * n
        rows.append(r + rng.integers(3, 50, extra).tolist())
    ids, mask = TChat.left_pad(rows, 0, bucket_multiple=16)
    pixels = rng.random((1, 64, 64, 3)).astype(np.float32)
    kw = dict(max_new_tokens=10, eos_token_id=2, pad_token_id=0)
    embeds = JChat._embeds_with_image(jp, jcfg, jnp.asarray(ids),
                                      jnp.asarray(pixels))
    toks_j, lens_j = JG.generate(jp["llm"], jcfg.llm,
                                 JG.GenerationConfig(**kw), embeds,
                                 jnp.asarray(mask))
    toks_t, lens_t = TChat.caption_ids(model, tcfg, pixels, ids, mask,
                                       TG.GenerationConfig(**kw))
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    # text only: no image scattered in
    toks_t, _ = TChat.caption_ids(model, tcfg, None, ids[:, -6:],
                                  mask[:, -6:], TG.GenerationConfig(**kw))
    toks_j, _ = JG.generate(jp["llm"], jcfg.llm, JG.GenerationConfig(**kw),
                            JM.embed_tokens(jp["llm"],
                                            jnp.asarray(ids[:, -6:])),
                            jnp.asarray(mask[:, -6:]))
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
