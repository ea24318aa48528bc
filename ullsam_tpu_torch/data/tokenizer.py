"""InternLM2 tokenizer on HF ``tokenizers`` (host side, no device work):
the port's own copy of ``ullsam_tpu/data/tokenizer.py`` (whose package
``__init__`` imports jax).

The reference wraps SentencePiece (``tokenization_internlm2.py``); without
the sentencepiece module the SPM protobuf is parsed directly, the BPE merge
table rebuilt from the piece ranks, and an equivalent fast tokenizer built
(byte fallback, metaspace handling). Special tokens follow the reference
assets: the <|im_start|>=92543 family and the image tokens 92544-92552
(``added_tokens.json``, ``tokenizer_config.json``). ``tokenizers`` and
``transformers`` are imported when a tokenizer is built, not with the
module. The serving entry points take any object with this interface:
``encode``, ``encode_batch``, ``decode``, ``convert_tokens_to_ids`` and
``pad_token_id``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

# Special token ids for the deployed InternVL2.5-2B vocab (SURVEY §2.14)
SPECIAL_TOKENS = {
    "<|im_end|>": 92542,
    "<|im_start|>": 92543,
    "<img>": 92544,
    "</img>": 92545,
    "<IMG_CONTEXT>": 92546,
    "<quad>": 92547,
    "</quad>": 92548,
    "<ref>": 92549,
    "</ref>": 92550,
    "<box>": 92551,
    "</box>": 92552,
}

IMG_CONTEXT_TOKEN = "<IMG_CONTEXT>"
IMG_START_TOKEN = "<img>"
IMG_END_TOKEN = "</img>"


def _extract_bpe_merges(vocab_scores):
    """Reconstruct BPE merges from an SPM-BPE piece table.

    For SPM BPE models the piece score encodes merge rank. For every piece,
    every split into two in-vocab halves is a candidate merge; candidates
    are ordered by the merged piece's rank (standard reconstruction used by
    GGUF/llama.cpp-style converters — no sentencepiece needed).
    """
    vocab = {tok: i for i, (tok, _) in enumerate(vocab_scores)}
    merges = []
    for tok, score in vocab_scores:
        if len(tok) < 2:
            continue
        local = []
        for i in range(1, len(tok)):
            left, right = tok[:i], tok[i:]
            if left in vocab and right in vocab:
                local.append((left, right))
        local.sort(key=lambda lr: (vocab[lr[0]], vocab[lr[1]]))
        for left, right in local:
            merges.append((left, right, score))
    merges.sort(key=lambda m: -m[2])
    return [(m[0], m[1]) for m in merges]


def _build_fast_tokenizer(spm_model_path: str, renames=None):
    """SPM-BPE proto -> tokenizers.Tokenizer (byte fallback, ▁ spaces).

    renames: {token_id: content} overrides for in-vocab pieces (InternLM2
    repurposes [UNUSED_TOKEN_*] slots for <|im_start|> etc. via
    tokenizer_config.json's added_tokens_decoder).
    """
    from tokenizers import Tokenizer, decoders, models, normalizers
    from transformers.convert_slow_tokenizer import import_protobuf

    proto_mod = import_protobuf()
    proto = proto_mod.ModelProto()
    with open(spm_model_path, "rb") as f:
        proto.ParseFromString(f.read())
    if proto.trainer_spec.model_type != 2:
        raise ValueError("expected an SPM-BPE model (trainer model_type 2)")

    vocab_scores = [(p.piece, p.score) for p in proto.pieces]
    for tid, content in (renames or {}).items():
        if tid < len(vocab_scores):
            vocab_scores[tid] = (content, vocab_scores[tid][1])
    merges = _extract_bpe_merges(vocab_scores)
    bpe = models.BPE({t: i for i, (t, _) in enumerate(vocab_scores)},
                     merges, unk_token=proto.trainer_spec.unk_piece,
                     fuse_unk=True, byte_fallback=True)
    tk = Tokenizer(bpe)
    norms = []
    if proto.normalizer_spec.add_dummy_prefix:
        norms.append(normalizers.Prepend("▁"))
    norms.append(normalizers.Replace(" ", "▁"))
    tk.normalizer = normalizers.Sequence(norms)
    tk.decoder = decoders.Sequence([
        decoders.ByteFallback(),
        decoders.Replace("▁", " "),
        decoders.Fuse(),
    ])
    return tk


class InternLM2Tokenizer:
    """Minimal fast-tokenizer wrapper: encode/decode + special-token lookup."""

    def __init__(self, spm_model_path: str,
                 added_tokens: Optional[dict] = None,
                 renames: Optional[dict] = None,
                 bos_token_id: int = 1, eos_token_id: int = 2,
                 pad_token_id: int = 2, add_bos: bool = True):
        from tokenizers import AddedToken

        self._tk = _build_fast_tokenizer(spm_model_path, renames=renames)
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.add_bos = add_bos

        extra = dict(SPECIAL_TOKENS)
        if added_tokens:
            extra.update(added_tokens)
        if renames:
            extra.update({c: i for i, c in renames.items()})
        # Register every special content as an AddedToken so the tokenizer
        # extracts them verbatim before BPE; contents already in the vocab
        # keep their existing ids, new ones append.
        ordered = sorted(extra.items(), key=lambda kv: kv[1])
        self._tk.add_special_tokens(
            [AddedToken(tok, special=True, normalized=False)
             for tok, _ in ordered])
        self._special = {t: self._tk.token_to_id(t) for t, _ in ordered}

    # -- encode/decode ----------------------------------------------------

    def encode(self, text: str, add_bos: Optional[bool] = None) -> List[int]:
        ids = self._tk.encode(text, add_special_tokens=False).ids
        if (self.add_bos if add_bos is None else add_bos):
            ids = [self.bos_token_id] + ids
        return ids

    def encode_batch(self, texts: Sequence[str], pad_side: str = "left",
                     add_bos: Optional[bool] = None):
        """Returns (ids [B, S], attention_mask [B, S]) as python lists."""
        encoded = [self.encode(t, add_bos=add_bos) for t in texts]
        max_len = max(len(e) for e in encoded)
        ids, mask = [], []
        for e in encoded:
            pad = [self.pad_token_id] * (max_len - len(e))
            ones = [1] * len(e)
            zeros = [0] * (max_len - len(e))
            if pad_side == "left":
                ids.append(pad + e)
                mask.append(zeros + ones)
            else:
                ids.append(e + pad)
                mask.append(ones + zeros)
        return ids, mask

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tk.decode(list(ids),
                               skip_special_tokens=skip_special_tokens)

    def convert_tokens_to_ids(self, token: str) -> int:
        tid = self._tk.token_to_id(token)
        if tid is None:
            raise KeyError(token)
        return tid

    @property
    def vocab_size(self) -> int:
        return self._tk.get_vocab_size()


def load_tokenizer(model_dir_or_file: Optional[str] = None) -> InternLM2Tokenizer:
    """Load from a directory containing tokenizer.model (or a direct path).

    Reads tokenizer_config.json (in-vocab piece renames via
    added_tokens_decoder) and added_tokens.json (new ids >= vocab size) when
    present. Falls back to ULLSAM_TOKENIZER env var.
    """
    import json

    path = model_dir_or_file or os.environ.get("ULLSAM_TOKENIZER")
    if path is None:
        raise FileNotFoundError(
            "no tokenizer path given; set ULLSAM_TOKENIZER or pass a path")
    renames, added = None, None
    if os.path.isdir(path):
        model_dir = path
        path = os.path.join(model_dir, "tokenizer.model")
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            renames = {int(i): d["content"]
                       for i, d in cfg.get("added_tokens_decoder", {}).items()}
        add_path = os.path.join(model_dir, "added_tokens.json")
        if os.path.exists(add_path):
            with open(add_path) as f:
                added = json.load(f)
    return InternLM2Tokenizer(path, added_tokens=added, renames=renames)
