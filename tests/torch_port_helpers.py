"""Shared helpers for the parity tests of ``ullsam_tpu_torch`` against
``ullsam_tpu``: one numpy seed feeds both packages, configs are built from
identical field values in each package's own config module, and torch runs
on a few CPU threads so the tests stay small under the xdist workers."""

import numpy as np
import torch

torch.set_num_threads(2)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(actual, expected, atol, rtol=0.0, name=""):
    np.testing.assert_allclose(to_np(actual), to_np(expected), atol=atol,
                               rtol=rtol, err_msg=name)


def jax_init(init_fn, seed, cfg):
    """``init_fn(PRNGKey(seed), cfg)`` compiled once: eager JAX init costs
    seconds of per-op dispatch on the CPU."""
    import jax
    return jax.jit(init_fn, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


def jax_params_to_numpy(params, rng=None, scale=0.1):
    """JAX param pytree -> numpy; with ``rng``, all-zero leaves (the zero
    init of rel-pos tables and pos_embed) get random values so the bias
    paths are exercised."""
    import jax

    def leaf(a):
        a = np.asarray(a)
        if rng is not None and a.size and not a.any():
            return (rng.standard_normal(a.shape) * scale).astype(a.dtype)
        return a

    return jax.tree_util.tree_map(leaf, params)


def tiny_fusion_config(C):
    """A small uLLSAM in config module ``C`` (either package): padded 16x16
    grid with 5x5 windows, one global block, a tiny InternLM2."""
    vit = C.ViTConfig(img_size=64, patch_size=4, embed_dim=32, depth=3,
                      num_heads=2, mlp_ratio=2.0, out_chans=16, window_size=5,
                      global_attn_indexes=(1,))
    return C.FusionConfig(
        sam=C.SamConfig(
            vit=vit,
            prompt_encoder=C.PromptEncoderConfig(
                embed_dim=16, image_embedding_size=(16, 16),
                input_image_size=(64, 64), mask_in_chans=8),
            mask_decoder=C.MaskDecoderConfig(
                transformer_dim=16, transformer_mlp_dim=32,
                transformer_num_heads=2, iou_head_hidden_dim=8)),
        llm=C.InternLM2Config(vocab_size=64, hidden_size=32,
                              intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=2),
        vit_feature_dim=16, img_context_token_id=50)


# the chat template's special tokens at the real InternLM2 vocab's ids
# (``data/tokenizer.py`` SPECIAL_TOKENS)
SPECIAL_IDS = {"<|im_end|>": 92542, "<|im_start|>": 92543, "<img>": 92544,
               "</img>": 92545, "<IMG_CONTEXT>": 92546}


class StubTokenizer:
    """A stand-in with the ``InternLM2Tokenizer`` interface (the real
    tokenizer asset is not in the repository): one id per character (3 +
    code point mod 90000) after a BOS of 1, the template's special tokens
    at their real ids, pad 2. Its <IMG_CONTEXT> id is the default
    ``img_context_token_id`` of both packages' FusionConfig."""
    pad_token_id, bos_token_id = 2, 1

    def __init__(self):
        import re
        self._pat = re.compile("|".join(re.escape(t) for t in SPECIAL_IDS))

    def encode(self, text, add_bos=True):
        ids, pos = ([1] if add_bos else []), 0
        for m in self._pat.finditer(text):
            ids += [3 + ord(c) % 90000 for c in text[pos:m.start()]]
            ids.append(SPECIAL_IDS[m.group()])
            pos = m.end()
        return ids + [3 + ord(c) % 90000 for c in text[pos:]]

    def encode_batch(self, texts, pad_side="left", add_bos=None):
        enc = [self.encode(t) for t in texts]
        n = max(map(len, enc))
        return ([[2] * (n - len(e)) + e for e in enc],
                [[0] * (n - len(e)) + [1] * len(e) for e in enc])

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i - 3) for i in ids
                       if 3 <= i < 90003 and not 0xD800 <= i - 3 < 0xE000)

    def convert_tokens_to_ids(self, token):
        return SPECIAL_IDS[token]


def patch_tokenizers(monkeypatch):
    """Make both packages' ``load_tokenizer`` (looked up when a CLI's
    ``main`` runs) return one StubTokenizer."""
    import ullsam_tpu.data.tokenizer as jtok
    import ullsam_tpu_torch.data.tokenizer as ttok

    stub = StubTokenizer()
    for mod in (jtok, ttok):
        monkeypatch.setattr(mod, "load_tokenizer", lambda path=None: stub)
    return stub


def write_synthetic_dataset(root, n=4, img_size=64, n_inst=3,
                            answer="Some cells.", pretrain=False):
    """``tests/test_data_and_train_cli.py``'s synthetic set: ``n`` random
    RGB PNGs under images/ and instance maps (``n_inst`` discs) under
    masks/, and a jsonl of SFT rows ({image_path, conversation}; with
    ``pretrain`` the {image, conversations} keys). Returns the jsonl's
    path."""
    import json
    import os

    from PIL import Image

    img_dir = os.path.join(root, "images")
    mask_dir = os.path.join(root, "masks")
    os.makedirs(img_dir), os.makedirs(mask_dir)
    rng = np.random.RandomState(0)
    rows = []
    for i in range(n):
        img = (rng.rand(img_size, img_size, 3) * 255).astype(np.uint8)
        mask = np.zeros((img_size, img_size), np.uint8)
        yy, xx = np.mgrid[:img_size, :img_size]
        for j in range(n_inst):
            cx, cy = rng.randint(10, img_size - 10, 2)
            r = rng.randint(4, 8) * img_size // 64
            mask[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = j + 1
        ipath = os.path.join(img_dir, f"{i}.png")
        Image.fromarray(img).save(ipath)
        Image.fromarray(mask).save(os.path.join(mask_dir, f"{i}.png"))
        conv = [{"role": "user", "content": "Describe the image.\n<image>"},
                {"role": "assistant", "content": answer}]
        rows.append({"image": ipath, "conversations": conv} if pretrain
                    else {"image_path": ipath, "conversation": conv})
    jsonl = os.path.join(root, "pretrain.jsonl" if pretrain else "data.jsonl")
    with open(jsonl, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return jsonl
