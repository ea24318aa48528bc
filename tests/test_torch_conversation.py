"""The port's host-side serving helpers against ullsam_tpu and the goldens:
its own copy of the chat templates (``models/ullsam/conversation.py``),
``pad_to_square`` / ``reverse_padding`` / ``normalize01``, the session
state of the app (``serve/state.py``), the BPE merge reconstruction of the
tokenizer (``data/tokenizer.py``), and that the serving modules import
neither jax nor ullsam_tpu.

Prompt strings, merges, padding and instance masks must be equal; the
session's resized display image within one uint8 level of JAX's (two f32
sums in another order can round a value at .5 the other way) and
``model_input`` within 1/255."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from ullsam_tpu.data import tokenizer as JTok
from ullsam_tpu.inference import transforms as JT
from ullsam_tpu.serve import state as JS
from ullsam_tpu_torch.data import tokenizer as TTok
from ullsam_tpu_torch.inference import transforms as TT
from ullsam_tpu_torch.models.ullsam import conversation as TConv
from ullsam_tpu_torch.serve import state as TS

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _prompt(name, question, history=None):
    t = TConv.get_conv_template(name)
    for q, a in (history or []):
        t.append_message(t.roles[0], q)
        t.append_message(t.roles[1], a)
    t.append_message(t.roles[0], question)
    t.append_message(t.roles[1], None)
    return t.get_prompt()


def test_prompt_strings_match_reference(goldens):
    g = goldens("conversation")
    assert _prompt("internlm2-chat", "Describe the image.\n<image>") == \
        str(g["internlm2_simple"])
    assert _prompt("internlm2-chat", "And now?",
                   history=[("Hi", "Hello!")]) == str(g["internlm2_history"])
    assert _prompt("Hermes-2", "What is this?\n<image>") == str(g["hermes"])
    assert _prompt("phi3-chat", "Segment the cell.\n<image>") == str(g["phi3"])
    assert _prompt("internvl2_5", "Caption.\n<image>") == str(g["internvl25"])


def test_build_chat_prompt_image_expansion():
    p = TConv.build_chat_prompt("internlm2-chat", "What is this?",
                                num_image_token=4)
    assert "<img>" + "<IMG_CONTEXT>" * 4 + "</img>" in p
    assert "<image>" not in p
    assert p.endswith("<|im_start|>assistant\n")
    assert "What is this?\n<img>" in p


@pytest.mark.parametrize("kw", [
    dict(question="Describe.", num_image_token=16),
    dict(question="Text only.", has_image=False),
    dict(question="And?", history=[("Hi", "Hello!")], num_image_token=8),
    dict(question="Two.\n<image>", num_patches_list=[2],
         system_message="sys", num_image_token=3)])
def test_build_chat_prompt_matches_jax(kw):
    from ullsam_tpu.models.ullsam.conversation import build_chat_prompt
    for name in ("internlm2-chat", "Hermes-2", "phi3-chat", "internvl2_5"):
        assert (TConv.build_chat_prompt(name, **kw)
                == build_chat_prompt(name, **kw)), name


def test_copy_isolation():
    a = TConv.get_conv_template("internlm2-chat")
    a.append_message(a.roles[0], "x")
    assert TConv.get_conv_template("internlm2-chat").messages == []


def test_all_separator_styles_match_reference_goldens():
    """Every style x scenario of ``conversation_styles.json`` (18 styles x
    4 scenarios), as ``tests/test_conversation.py`` pins the JAX copy."""
    gold = json.loads((ROOT / "tests" / "goldens" /
                       "conversation_styles.json").read_text())
    base_roles = ("USER", "ASSISTANT")
    chat = [["USER", "hi there"], ["ASSISTANT", "hello!"],
            ["USER", "tell me more"], ["ASSISTANT", None]]
    single = [["USER", "only question"], ["ASSISTANT", None]]
    messy = [["USER", "line1\r\nline2\n\nline3"], ["ASSISTANT", None]]
    scenarios = [
        ("full", dict(name="t", system_template="SYS: {system_message}",
                      system_message="be helpful", roles=base_roles,
                      sep="\n", sep2="</s>"), chat),
        ("nosys", dict(name="t", system_template="{system_message}",
                       system_message="", roles=base_roles,
                       sep="\n", sep2="</s>"), single),
        ("messy", dict(name="t", system_template="{system_message}",
                       system_message="sys", roles=base_roles,
                       sep=" ", sep2="<e>"), messy),
        ("glm2", dict(name="chatglm2", system_template="{system_message}",
                      system_message="sys", roles=("问", "答"),
                      sep="\n", sep2="</s>"), chat),
    ]
    checked = 0
    for style in TConv.SeparatorStyle:
        for scen_name, kw, messages in scenarios:
            conv = TConv.Conversation(messages=[list(m) for m in messages],
                                      sep_style=style, **kw)
            key = f"{style.name}/{scen_name}"
            assert conv.get_prompt() == gold[key], key
            checked += 1
    assert checked == len(gold) == 72


def test_mpt_tuple_message_and_openai_export():
    conv = TConv.Conversation(name="t", system_message="s",
                              roles=("u:", "a:"),
                              sep_style=TConv.SeparatorStyle.MPT, sep="|")
    conv.messages = [["u:", ("look", None, None)], ["a:", None]]
    assert conv.get_prompt() == "s|u:look|a:"
    conv2 = TConv.Conversation(name="t", system_message="sys")
    conv2.messages = [["USER", "q1"], ["ASSISTANT", "a1"],
                      ["USER", "q2"], ["ASSISTANT", None]]
    assert conv2.to_openai_api_messages() == [
        {"role": "system", "content": "sys"},
        {"role": "user", "content": "q1"},
        {"role": "assistant", "content": "a1"},
        {"role": "user", "content": "q2"}]


@pytest.mark.parametrize("hw", [(50, 80), (80, 50), (33, 33), (7, 12)])
def test_pad_to_square_and_reverse_match_jax(hw):
    img = (np.random.RandomState(0).rand(*hw, 3) * 255).astype(np.uint8)
    got, info = TT.pad_to_square(img, fill=3)
    want, want_info = JT.pad_to_square(img, fill=3)
    np.testing.assert_array_equal(got, want)
    assert info == want_info
    np.testing.assert_array_equal(TT.reverse_padding(got, info), img)
    np.testing.assert_array_equal(TT.normalize01(img), JT.normalize01(img))


def test_session_matches_jax_session():
    """``tests/test_serve_app.py``'s session workflow on both packages:
    ingest (pad, resize to 128), a click, a saved instance, the uint16
    export in the original frame, the overlay and the TIFF, then reset."""
    img = (np.random.RandomState(0).rand(50, 80, 3) * 255).astype(np.uint8)
    sessions = []
    for S in (TS, JS):
        s = S.Session()
        s.set_image(img, target=128)
        s.add_point(10, 20, 1)
        s.current_mask = np.zeros((128, 128), bool)
        s.current_mask[30:60, 30:60] = True
        view = S.instance_overlay(s.display, s.instances, s.current_mask)
        assert s.save_instance() == 1 and s.points == []
        sessions.append((s, view, S.export_instance_mask(s.instances,
                                                         s.geometry)))
    (t, tview, texp), (j, jview, jexp) = sessions
    assert t.display.shape == (128, 128, 3)
    assert t.geometry == j.geometry and t.geometry["orig_hw"] == (50, 80)
    assert np.abs(t.display.astype(int) - j.display.astype(int)).max() <= 1
    np.testing.assert_allclose(t.model_input, j.model_input, atol=1 / 255)
    assert np.abs(tview.astype(int) - jview.astype(int)).max() <= 1
    assert texp.shape == (50, 80) and texp.dtype == np.uint16
    np.testing.assert_array_equal(texp, jexp)
    assert t.export_tiff()[:2] in (b"II", b"MM")
    t.reset_instances()
    assert t.instances.max() == 0 and t.next_instance_id == 1


def test_gray_and_float_images_ingest_like_jax():
    rng = np.random.RandomState(1)
    for img in (rng.rand(40, 30) * 1000, (rng.rand(64, 64, 4) * 255
                                          ).astype(np.uint8)):
        got, want = TS.ingest_image(img, 64), JS.ingest_image(img, 64)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_extract_bpe_merges_matches_jax():
    """A small SPM-BPE piece table (pieces, scores as merge ranks): the
    rebuilt merge list equals the JAX package's, order included."""
    pieces = ["<unk>", "<s>", "</s>", "▁", "a", "b", "c", "ab", "bc",
              "▁a", "abc", "▁ab", "▁abc", "ca", "cab"]
    scores = [0.0, 0.0, 0.0, -1.0, -2.0, -3.0, -4.0, -5.0, -6.0, -7.0,
              -8.0, -9.0, -10.0, -11.0, -12.0]
    table = list(zip(pieces, scores))
    got = TTok._extract_bpe_merges(table)
    assert got == JTok._extract_bpe_merges(table)
    assert ("a", "b") in got and got.index(("a", "b")) < got.index(("ab", "c"))
    assert TTok.SPECIAL_TOKENS == JTok.SPECIAL_TOKENS


def test_serving_modules_import_no_jax():
    """Importing the port's serving modules in a fresh interpreter leaves
    jax and ullsam_tpu out of sys.modules."""
    code = (
        "import sys\n"
        "import ullsam_tpu_torch.serve.app, ullsam_tpu_torch.serve.engine\n"
        "import ullsam_tpu_torch.serve.state, ullsam_tpu_torch.data.tokenizer\n"
        "import ullsam_tpu_torch.models.ullsam.conversation\n"
        "import ullsam_tpu_torch.models.ullsam.chat\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'ullsam_tpu.'))\n"
        "             or m == 'ullsam_tpu')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
