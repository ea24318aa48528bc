"""The port's serving path against ullsam_tpu: the continuous-batching
engine (``serve/engine.py``) against JAX's ``GenerationEngine`` and against
the port's own ``generate``, chunked against whole-prompt admission,
per-request sampling, the int8 engine, streaming, the tokenizer-taking chat
entry points (``chat``, ``batch_chat``, ``stream_chat``,
``segment_forward``) and the HTTP app driven through ``_smoke``.

The tokenizer asset is not in the repository, so a stub stands in for it:
one id per character, the chat template's special tokens at their real ids.
Models: the widths of ``tests/test_engine.py`` ``_tiny_setup`` (LLM hidden
32, the deployed vocab of 92553), one set of JAX weights carried over by
``fusion_state_dict_from_jax``, f32 on the CPU. Tolerances: greedy token
ids and texts equal (f32, only the summation order differs, and the logit
gaps of these weights are far above it); ``segment_forward``'s outputs
within 1e-4 of max|JAX|."""

import importlib
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_init, jax_params_to_numpy

from ullsam_tpu.core import config as JC
from ullsam_tpu.models.ullsam import fusion as JF
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.models.internlm2 import generate as TG
from ullsam_tpu_torch.models.ullsam import chat as TChat
from ullsam_tpu_torch.models.ullsam import fusion as TF
from ullsam_tpu_torch.serve import app as TApp
from ullsam_tpu_torch.serve import engine as TE

# the package __init__s re-export functions named ``generate`` and ``chat``
JG = importlib.import_module("ullsam_tpu.models.internlm2.generate")
JChat = importlib.import_module("ullsam_tpu.models.ullsam.chat")
SPECIAL = {"<|im_end|>": 92542, "<|im_start|>": 92543, "<img>": 92544,
           "</img>": 92545, "<IMG_CONTEXT>": 92546}
MAX_NEW = 8


class StubTokenizer:
    """One id per character (3 + code point mod 90000) after a BOS of 1,
    the template's special tokens at their ids; pad 2. Decoding skips the
    ids that are no character."""
    pad_token_id, bos_token_id = 2, 1
    _pat = re.compile("|".join(re.escape(t) for t in SPECIAL))

    def encode(self, text, add_bos=True):
        ids, pos = ([1] if add_bos else []), 0
        for m in self._pat.finditer(text):
            ids += [3 + ord(c) % 90000 for c in text[pos:m.start()]]
            ids.append(SPECIAL[m.group()])
            pos = m.end()
        return ids + [3 + ord(c) % 90000 for c in text[pos:]]

    def encode_batch(self, texts, pad_side="left", add_bos=None):
        enc = [self.encode(t) for t in texts]
        n = max(map(len, enc))
        ids = [[2] * (n - len(e)) + e for e in enc]
        mask = [[0] * (n - len(e)) + [1] * len(e) for e in enc]
        return ids, mask

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i - 3) for i in ids
                       if 3 <= i < 90003 and not 0xD800 <= i - 3 < 0xE000)

    def convert_tokens_to_ids(self, token):
        return SPECIAL[token]


def _config(C):
    """``_tiny_setup``'s widths in config module ``C``."""
    return C.FusionConfig(
        sam=C.SamConfig(
            vit=C.ViTConfig(img_size=64, patch_size=8, embed_dim=16, depth=1,
                            num_heads=2, mlp_ratio=1.0, out_chans=16,
                            window_size=2, global_attn_indexes=()),
            prompt_encoder=C.PromptEncoderConfig(
                embed_dim=16, image_embedding_size=(8, 8),
                input_image_size=(64, 64), mask_in_chans=8),
            mask_decoder=C.MaskDecoderConfig(
                transformer_dim=16, transformer_mlp_dim=32,
                transformer_num_heads=2, iou_head_hidden_dim=8)),
        llm=C.InternLM2Config(vocab_size=92553, hidden_size=32,
                              intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=2),
        vit_feature_dim=16)


# five requests: images on the even ones, the last long enough for two
# prefill segments of 128
QUESTIONS = ["Question 0?", "What is shown?", "Name one object.",
             "Count the cells.",
             "Describe the staining pattern. " * 4]
IMG = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _config(JC), _config(TC)
    p = jax_params_to_numpy(jax_init(JF.fusion_init, 0, jcfg))
    model = TF.ULLSAM(tcfg, device="cpu")
    model.load_state_dict(X.fusion_state_dict_from_jax(p, tcfg))
    model.eval()
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, p), model


def _port_engine(setup, **kw):
    _, tcfg, _, model = setup
    kw = dict(dict(max_batch=2, max_len=512, cache_dtype=torch.float32,
                   gen=TG.GenerationConfig(max_new_tokens=MAX_NEW),
                   prefill_chunk=128, device="cpu"), **kw)
    return TE.GenerationEngine(model, tcfg, StubTokenizer(), **kw)


def _jax_engine(setup, **kw):
    from ullsam_tpu.serve.engine import GenerationEngine
    jcfg, _, jp, _ = setup
    return GenerationEngine(jp, jcfg, StubTokenizer(), max_batch=2,
                            max_len=512, cache_dtype=jnp.float32,
                            gen=JG.GenerationConfig(max_new_tokens=MAX_NEW),
                            prefill_chunk=128, **kw)


def _concurrent(submit, n):
    """Run submit(i) for i < n on n threads at once; their results."""
    out = {}

    def go(i):
        out[i] = submit(i)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return [out[i] for i in range(n)]


def _prompt(i):
    has_image = i % 2 == 0
    ids = StubTokenizer().encode(JChat.build_chat_prompt(
        "internlm2-chat", QUESTIONS[i], num_image_token=16,
        has_image=has_image))
    return ids, (IMG if has_image else None)


def _port_tokens(eng, n, **kw):
    def submit(i):
        ids, pv = _prompt(i)
        req = eng.submit_ids(ids, pv, MAX_NEW, **kw)
        assert req.event.wait(60) and req.error is None, req.error
        return req.tokens
    return _concurrent(submit, n)


def _jax_tokens(eng, n):
    from ullsam_tpu.serve.engine import _Request

    def submit(i):
        ids, pv = _prompt(i)
        req = _Request(np.asarray(ids, np.int32), pv, MAX_NEW, gen=eng.gen)
        eng.queue.put(req)
        assert req.event.wait(120) and req.error is None, req.error
        return req.tokens
    return _concurrent(submit, n)


@pytest.fixture(scope="module")
def port_run(setup):
    eng = _port_engine(setup)
    try:
        toks = _port_tokens(eng, 5)
        return toks, dict(eng.phase_stats)
    finally:
        eng.shutdown()


def test_engine_matches_jax_engine(setup, port_run):
    """5 concurrent greedy requests (3 with the image, one prompt in two
    segments) into 2 slots: the port's engine emits exactly JAX's token
    ids, request by request."""
    assert max(len(_prompt(i)[0]) for i in range(5)) > 128
    eng = _jax_engine(setup)
    try:
        want = _jax_tokens(eng, 5)
    finally:
        eng.shutdown()
    got, stats = port_run
    assert got == want
    assert stats["chunks"] > 0 and stats["steps"] >= stats["chunks"]


def test_engine_matches_generate(setup, port_run):
    """Each engine request's tokens are the port's batch-1 ``caption_ids``
    tokens for its prompt, up to and including the first EOS."""
    _, tcfg, _, model = setup
    gen = TG.GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=92542,
                              pad_token_id=2)
    for i, got in enumerate(port_run[0]):
        ids, pv = _prompt(i)
        toks, lens = TChat.caption_ids(model, tcfg, pv,
                                       *TChat.left_pad([ids], 2), gen)
        assert got == toks[0, :int(lens[0])].tolist(), i


def test_bf16_cache_engine_matches_generate(setup):
    """The engine's own default, a bf16 cache under the f32 model (the
    app's ``--dtype float32``): each request's tokens are batch-1
    ``caption_ids``' with a bf16 cache, up to and including the first EOS,
    and its prefill logits within 1e-5 (relative L2) of that call's, where
    the f32 cache's call lies further off (the bf16 cache reaches the
    prefill's attention)."""
    _, tcfg, _, model = setup
    eng = _port_engine(setup, cache_dtype=torch.bfloat16)

    def submit(i):
        req = eng.submit_ids(*_prompt(i), MAX_NEW)
        assert req.event.wait(60) and req.error is None, req.error
        return req
    try:
        reqs = _concurrent(submit, 5)
    finally:
        eng.shutdown()
    gen = TG.GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=92542,
                              pad_token_id=2)
    for i, req in enumerate(reqs):
        ids, pv = _prompt(i)
        out = {}
        for dt in (torch.bfloat16, torch.float32):
            first = []
            toks, lens = TChat.caption_ids(
                model, tcfg, pv, *TChat.left_pad([ids], 2), gen,
                step_hook=lambda j, lg: first.append(lg[0]) if j == 0
                else None, cache_dtype=dt)
            out[dt] = toks[0, :int(lens[0])].tolist(), first[0]
        assert req.tokens == out[torch.bfloat16][0], i
        ref, f32 = out[torch.bfloat16][1], out[torch.float32][1]
        near = float((req.first_logits - ref).norm() / ref.norm())
        apart = float((f32 - ref).norm() / ref.norm())
        assert near <= 1e-5 < apart, (i, near, apart)


def test_chunked_prefill_matches_whole_prompt(setup):
    """A 320-character prompt in segments of 128 gives the greedy tokens of
    the same prompt prefilled whole (one segment of 384)."""
    q = "Describe the staining pattern. " * 10
    outs = []
    for chunk in (128, 4096):
        eng = _port_engine(setup, prefill_chunk=chunk, max_len=1024)
        try:
            outs.append(eng.submit_ids(eng.prompt_ids(q, False), None,
                                       MAX_NEW))
            assert outs[-1].event.wait(60) and outs[-1].error is None
        finally:
            eng.shutdown()
    assert len(outs[0].input_ids) > 256
    assert outs[0].tokens == outs[1].tokens


def test_per_request_sampling_leaves_greedy_rows_greedy(setup):
    """A greedy request decoding beside a sampled one (temperature 0.7,
    top-p 0.9, top-k 50) keeps its greedy tokens; a sampled request with
    top-k 1 is greedy too; sampled draws repeat under the engine's seed."""
    eng = _port_engine(setup)
    try:
        base = eng.caption(None, "Same question", max_new_tokens=MAX_NEW)
        runs = _concurrent(lambda i: eng.caption(
            None, ["Same question", "Other question"][i],
            max_new_tokens=MAX_NEW, **[{}, dict(
                do_sample=True, temperature=0.7, top_p=0.9, top_k=50)][i]), 2)
        top1 = eng.caption(None, "Same question", max_new_tokens=MAX_NEW,
                           do_sample=True, top_k=1)
    finally:
        eng.shutdown()
    assert runs[0] == base and top1 == base
    assert isinstance(runs[1], str)
    draws = []
    for _ in range(2):
        eng = _port_engine(setup, seed=3)
        try:
            draws.append(eng.caption(None, "Other question",
                                     max_new_tokens=MAX_NEW, do_sample=True,
                                     temperature=2.0))
        finally:
            eng.shutdown()
    assert draws[0] == draws[1]


def test_int8_engine_matches_jax_int8_engine(setup):
    """``quant="int8"``: the port's engine (its own int8 copy of the LLM,
    the model left as it was) emits JAX's int8 engine's token ids for a
    text request and an image request side by side."""
    _, tcfg, _, model = setup
    before = {k: v.clone() for k, v in model.state_dict().items()}
    eng = _port_engine(setup, quant="int8")
    try:
        got = _port_tokens(eng, 2)
    finally:
        eng.shutdown()
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())
    jeng = _jax_engine(setup, quant="int8")
    try:
        want = _jax_tokens(jeng, 2)
    finally:
        jeng.shutdown()
    assert got == want


def test_stream_caption_joins_to_caption(setup):
    """``stream_caption``'s deltas, joined, are ``caption``'s text (image
    request), and none ends in U+FFFD."""
    eng = _port_engine(setup)
    try:
        text = eng.caption(IMG, "Describe.", max_new_tokens=MAX_NEW)
        deltas = list(eng.stream_caption(IMG, "Describe.",
                                         max_new_tokens=MAX_NEW))
    finally:
        eng.shutdown()
    assert "".join(deltas).strip() == text
    assert not any(d.endswith("\ufffd") for d in deltas)


def test_chat_entry_points_match_jax(setup):
    """``chat`` (image), ``batch_chat`` (two text questions of different
    lengths, left-padded), ``stream_chat``'s deltas and
    ``segment_forward``'s (dense_prompt, sam_features) against JAX's with
    the same stub tokenizer: texts and deltas equal, features 1e-4 of
    max|JAX|."""
    jcfg, tcfg, jp, model = setup
    tk = StubTokenizer()
    gen_j = JG.GenerationConfig(max_new_tokens=MAX_NEW)
    gen_t = TG.GenerationConfig(max_new_tokens=MAX_NEW)
    assert (TChat.chat(model, tcfg, tk, IMG, "Describe.", gen=gen_t)
            == JChat.chat(jp, jcfg, tk, jnp.asarray(IMG), "Describe.",
                          gen=gen_j))
    qs = ["Hi?", "What is in the picture, in detail?"]
    got, hist = TChat.batch_chat(model, tcfg, tk, None, qs, gen=gen_t)
    want, _ = JChat.batch_chat(jp, jcfg, tk, None, qs, gen=gen_j)
    assert got == want and hist[1] == [(qs[1], got[1])]
    assert (list(TChat.stream_chat(model, tcfg, tk, IMG, "Describe.",
                                   gen=gen_t))
            == list(JChat.stream_chat(jp, jcfg, tk, jnp.asarray(IMG),
                                      "Describe.", gen=gen_j)))
    got = TChat.segment_forward(model, tcfg, tk, IMG)
    want = JChat.segment_forward(jp, jcfg, tk, jnp.asarray(IMG))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=1e-4 * np.abs(b).max())


def test_app_smoke_with_engine(setup):
    """The port's app with the engine on the CPU, served on a free port and
    driven through ``_smoke``: image, two clicks, mask, save, view, TIFF
    export, caption and caption stream; then ``main(--tiny --smoke
    --engine)`` exits 0."""
    _, tcfg, _, model = setup
    eng = _port_engine(setup)
    app = TApp.AppServer(model, tcfg, StubTokenizer(), engine=eng)
    try:
        assert TApp.serve_smoke(app)
    finally:
        eng.shutdown()
    sess = app.session("s")
    assert sess.instances.max() == 1 and sess.sam_features is not None
    with pytest.raises(SystemExit) as exc:
        TApp.main(["--tiny", "--smoke", "--engine", "--device", "cpu",
                   "--port", "0", "--dtype", "float32", "--max_len", "512"],
                  tokenizer=StubTokenizer())
    assert exc.value.code == 0


def test_uncounted_restores_b12_counts():
    """``int8_matmul.uncounted``, which the engine wraps around a graph's
    capture (the capture records launches that do not run then), puts
    B12's wrapper count and its per-kernel counts back as they were (the
    engine's decode step at 2-16 rows runs the tensor-core body)."""
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    step = Q.kernel_launches["w8a16_decode_tc"]
    saved = (Q.w8a16_matmul.launches, step.launches)
    try:
        Q.w8a16_matmul.launches, step.launches = 7, 3
        with Q.uncounted():
            Q.w8a16_matmul.launches += 121
            step.launches += 121
        assert (Q.w8a16_matmul.launches, step.launches) == (7, 3)
    finally:
        Q.w8a16_matmul.launches, step.launches = saved
