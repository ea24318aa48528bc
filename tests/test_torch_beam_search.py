"""The port's ``beam_search`` (``ullsam_tpu_torch/models/internlm2/
generate.py``) against the JAX package's on ``internlm2_tiny`` weights
carried across with ``internlm2_arrays``, f32 on the CPU.

The head gets an eos bias in some cases (JAX ``output.bias``, the port's
head a biased ``Linear``): 2.2 makes eos win mid-sequence, so the best
hypothesis comes from the finished pool; 2.5 makes beams begin with eos,
so they finish at once and the alive candidates tie at ``-inf``.

Tolerances: tokens equal; the score within 1e-5 (a sum of a few f32
log-probabilities, summation order only); int8 (the plain B12 on both
sides) tokens equal, score 1e-5."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_init, jax_params_to_numpy

from ullsam_tpu.core import config as JC
from ullsam_tpu.models.internlm2 import model as JM
from ullsam_tpu.models.internlm2 import quant as JQ
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.models.internlm2 import generate as TG
from ullsam_tpu_torch.models.internlm2 import model as TM
from ullsam_tpu_torch.models.internlm2 import quant as TQ
from ullsam_tpu_torch.ops import layers as TL

JG = importlib.import_module("ullsam_tpu.models.internlm2.generate")
IDS = [[5, 9, 11, 42]]
T_NEW = 8


@pytest.fixture(scope="module")
def weights():
    jcfg = JC.internlm2_tiny()
    return jcfg, jax_params_to_numpy(jax_init(JM.internlm2_init, 0, jcfg))


def _models(weights, eos_bias=None, int8=False):
    """(JAX params, port model) with the same weights, the head's eos
    bias, int8 linears on both sides."""
    jcfg, p = weights
    cfg = TC.internlm2_tiny()
    p = jax.tree_util.tree_map(np.array, p)
    if eos_bias is not None:
        bias = np.zeros((cfg.vocab_size,), np.float32)
        bias[cfg.eos_token_id] = eos_bias
        p["output"]["bias"] = bias
    if int8:
        p = jax.tree_util.tree_map(np.asarray, JQ.quantize_llm_int8(p))
    lm = TM.InternLM2ForCausalLM(cfg, device="cpu")
    if eos_bias is not None:
        lm.output = TL.Linear(cfg.hidden_size, cfg.vocab_size, bias=True,
                              device="cpu")
    if int8:
        TQ.quantize_llm_int8(lm)
    X.load_reference_state_dict(lm, X.internlm2_arrays(p, cfg))
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, p), lm.eval()


def _both(weights, num_beams, **kw):
    jcfg, cfg, jp, lm = _models(weights, **kw)
    ids = jnp.asarray(IDS)
    jt, js = JG.beam_search(jp, jcfg, JM.embed_tokens(jp, ids),
                            jnp.ones_like(ids), num_beams=num_beams,
                            max_new_tokens=T_NEW)
    tids = torch.tensor(IDS)
    tt, ts = TG.beam_search(lm, cfg, TM.embed_tokens(lm, tids),
                            torch.ones_like(tids), num_beams=num_beams,
                            max_new_tokens=T_NEW)
    return (np.asarray(jt), float(js)), (tt, float(ts)), (cfg, lm)


@pytest.mark.parametrize("eos_bias", [None, 2.2, 2.5],
                         ids=["plain", "eos_mid", "eos_first"])
@pytest.mark.parametrize("num_beams", [1, 2, 4])
def test_beam_search_matches_jax(weights, num_beams, eos_bias):
    (jt, js), (tt, ts), (cfg, _) = _both(weights, num_beams,
                                         eos_bias=eos_bias)
    assert tt.dtype == torch.int32 and tt.shape == (T_NEW,)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert ts == pytest.approx(js, abs=1e-5)
    eos = cfg.eos_token_id
    if eos_bias == 2.2 and num_beams == 4:
        # the finished pool's hypothesis: eos after a few tokens, pad on
        assert eos in tt[1:].tolist() and tt[0] != eos
    if eos_bias == 2.5:
        assert tt[0] == eos


def test_beam_search_int8_matches_jax(weights):
    (jt, js), (tt, ts), _ = _both(weights, 4, int8=True)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert ts == pytest.approx(js, abs=1e-5)


def _seq_logprob(lm, tokens, cfg):
    """The continuation's total log-probability under one forward."""
    toks = [int(t) for t in tokens if int(t) != cfg.pad_token_id]
    full = torch.tensor([IDS[0] + toks])
    with torch.no_grad():
        logits = TM.internlm2_forward(lm, cfg, input_ids=full)["logits"]
    logp = torch.log_softmax(logits.float(), -1)
    return sum(float(logp[0, len(IDS[0]) - 1 + i, t])
               for i, t in enumerate(toks))


def test_one_beam_is_greedy_and_beams_beat_greedy(weights):
    """``num_beams=1`` gives greedy ``generate``'s tokens (no eos on this
    path), and four beams a log-probability at least greedy's (the JAX
    test's property)."""
    _, cfg, _, lm = _models(weights)
    tids = torch.tensor(IDS)
    emb = TM.embed_tokens(lm, tids)
    greedy, _ = TG.generate(lm, cfg, TG.GenerationConfig(
        max_new_tokens=T_NEW, eos_token_id=cfg.eos_token_id,
        pad_token_id=cfg.pad_token_id), emb, torch.ones_like(tids))
    assert cfg.eos_token_id not in greedy[0].tolist()
    one, _ = TG.beam_search(lm, cfg, emb, torch.ones_like(tids),
                            num_beams=1, max_new_tokens=T_NEW)
    assert torch.equal(one, greedy[0])
    four, _ = TG.beam_search(lm, cfg, emb, torch.ones_like(tids),
                             num_beams=4, max_new_tokens=T_NEW)
    g = _seq_logprob(lm, greedy[0], cfg)
    b = _seq_logprob(lm, four, cfg)
    assert b >= g - 1e-4, (b, g)


def test_beam_search_refuses_a_batch(weights):
    _, cfg, _, lm = _models(weights)
    ids = torch.tensor(IDS * 2)
    with pytest.raises(ValueError, match="one prompt"):
        TG.beam_search(lm, cfg, TM.embed_tokens(lm, ids),
                       torch.ones_like(ids))
