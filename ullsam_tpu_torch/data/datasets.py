"""Host data pipeline (``ullsam_tpu/data/datasets.py``): jsonl datasets and
fixed-shape numpy batches, the port's own copy (the JAX package's module
imports jax through its package).

Behavioral reference: MultimodalPretrainDataset / MultimodalSFTDataset /
MultimodalSegDataset (train_joint_v2.py:50-600), with the JAX package's
choices kept exactly:
  * fixed-shape outputs (pad to max everywhere); variable instance counts
    are padded with an ``instance_valid`` mask;
  * rows whose image file is missing are skipped;
  * per-process sharding by index stride replaces DistributedSampler;
  * the assistant-marker token ids come from the tokenizer (the reference
    hardcodes 92543/525/11353, :132-145);
  * labels are -100 before the first assistant turn, on padding and on
    <IMG_CONTEXT>;
  * ``SegDataset.example(idx)`` seeds its rng with the index.

Everything here is numpy on the host; the train step moves a batch to the
device (``train/step.py`` ``batch_on``). The packed-row helpers live in
``data/packing.py`` and are re-exported from here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from ullsam_tpu_torch.data.packing import (pack_examples,  # noqa: F401
                                           packed_batch_iterator_sharded)
from ullsam_tpu_torch.data.point_sampling import sample_instance_points
from ullsam_tpu_torch.data.tokenizer import (IMG_CONTEXT_TOKEN, IMG_END_TOKEN,
                                             IMG_START_TOKEN)
from ullsam_tpu_torch.models.ullsam.conversation import get_conv_template


def load_image_rgb(path: str, img_size: int) -> np.ndarray:
    """[img_size, img_size, 3] float32 in [0, 1] (the uLLSAM training path
    feeds [0, 1] tensors: Normalize(mean=0, std=1), train_joint_v2.py:75-79)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((img_size, img_size))
    return np.asarray(img, np.float32) / 255.0


def load_instance_map(path: str, img_size: int) -> np.ndarray:
    """An instance-id map (0 = background) as [img_size, img_size] int32,
    resized by nearest neighbour so ids stay whole."""
    from PIL import Image

    m = Image.open(path).convert("I").resize((img_size, img_size),
                                             Image.NEAREST)
    return np.asarray(m)


@dataclasses.dataclass
class DatasetConfig:
    data_path: str
    images_root: Optional[str] = None
    max_length: int = 1280
    img_size: int = 1024
    num_image_token: int = 1024
    template: str = "internlm2-chat"
    # seg-only
    num_pos_points: int = 1
    num_neg_points: int = 3
    sam_max_point_bs: int = 4


class _JsonlDataset:
    """jsonl rows with an image path; rows whose image is missing are
    skipped (train_joint_v2.py:82-91)."""

    image_key = "image"
    conv_key = "conversations"

    def __init__(self, cfg: DatasetConfig, tokenizer):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.rows = []
        with open(cfg.data_path, "r", encoding="utf-8") as f:
            for line in f:
                item = json.loads(line.strip())
                path = item.get(self.image_key) or item.get("image_path")
                if cfg.images_root:
                    path = os.path.join(cfg.images_root, path)
                if not os.path.exists(path):
                    continue
                item["image_path"] = path
                self.rows.append(item)
        self.assistant_marker = tokenizer.encode("<|im_start|>assistant",
                                                 add_bos=False)
        self.img_context_token_id = tokenizer.convert_tokens_to_ids(
            IMG_CONTEXT_TOKEN)

    def __len__(self):
        return len(self.rows)

    def _build_prompt(self, conversation: List[dict]) -> str:
        t = get_conv_template(self.cfg.template)
        image_tokens = (IMG_START_TOKEN
                        + IMG_CONTEXT_TOKEN * self.cfg.num_image_token
                        + IMG_END_TOKEN)
        for msg in conversation:
            role, content = msg["role"], msg["content"]
            if role == "user" and "<image>" in content:
                content = content.replace("<image>", image_tokens)
            t.append_message(t.roles[0 if role == "user" else 1], content)
        return t.get_prompt()

    def _tokenize(self, prompt: str):
        ids = self.tokenizer.encode(prompt)[: self.cfg.max_length]
        pad = self.cfg.max_length - len(ids)
        attn = np.asarray([1] * len(ids) + [0] * pad, np.int32)
        ids = np.asarray(ids + [self.tokenizer.pad_token_id] * pad, np.int32)

        labels = ids.copy()
        m = self.assistant_marker
        first = next((i for i in range(len(ids) - len(m) + 1)
                      if list(ids[i:i + len(m)]) == m), None)
        if first is None:
            labels[:] = -100
        else:
            labels[:first] = -100
        labels[attn == 0] = -100
        labels[ids == self.img_context_token_id] = -100
        return ids, attn, labels

    def example(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.rows[idx]
        conv = item.get(self.conv_key) or item.get("conversation")
        ids, attn, labels = self._tokenize(self._build_prompt(conv))
        pixel = load_image_rgb(item["image_path"], self.cfg.img_size)
        return {"input_ids": ids, "attention_mask": attn, "labels": labels,
                "pixel_values": pixel}


class PretrainDataset(_JsonlDataset):
    """jsonl {image, conversations[]} (train_joint_v2.py:50-158)."""

    image_key = "image"
    conv_key = "conversations"


class SFTDataset(_JsonlDataset):
    """jsonl {image_path, conversation[]} (train_joint_v2.py:160-250)."""

    image_key = "image_path"
    conv_key = "conversation"


class SegDataset(_JsonlDataset):
    """SFT rows plus instance masks (``mask_path``, else the image path with
    images -> masks; train_joint_v2.py:252-600): padded point prompts and
    ground-truth masks."""

    image_key = "image_path"
    conv_key = "conversation"

    def example(self, idx: int, seed: Optional[int] = None
                ) -> Dict[str, np.ndarray]:
        base = super().example(idx)
        cfg = self.cfg
        rng = np.random.default_rng(seed if seed is not None else idx)

        item = self.rows[idx]
        mask_path = item.get("mask_path") or item["image_path"].replace(
            "images", "masks")

        I = cfg.sam_max_point_bs
        P = cfg.num_pos_points + cfg.num_neg_points
        S = cfg.img_size
        masks = np.zeros((I, S, S), np.float32)
        coords = np.zeros((I, P, 2), np.float32)
        plabels = np.zeros((I, P), np.int32)
        valid = np.zeros((I,), np.float32)

        if os.path.exists(mask_path):
            m = load_instance_map(mask_path, S)
            ids = np.unique(m)
            ids = ids[ids > 0]
            if len(ids) > 0:
                chosen = rng.choice(ids, min(len(ids), I), replace=False)
                for j, inst in enumerate(chosen):
                    inst_mask = m == inst
                    pts, labs = sample_instance_points(
                        inst_mask, rng, num_pos=cfg.num_pos_points,
                        num_neg=cfg.num_neg_points)
                    masks[j] = inst_mask.astype(np.float32)
                    coords[j] = pts
                    plabels[j] = labs
                    valid[j] = 1.0

        base.update({"masks": masks, "point_coords": coords,
                     "point_labels": plabels, "instance_valid": valid})
        return base


def batch_iterator_sharded(dataset, batch_size: int, *, shuffle: bool = True,
                           seed: int = 0, process_index: int = 0,
                           process_count: int = 1, drop_last: bool = True,
                           epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Batches of this process's share of the (seeded, per-epoch) order:
    every ``process_count``-th index from ``process_index`` (replaces
    DistributedSampler, train_joint_v2.py:1711)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    order = order[process_index::process_count]
    usable = (len(order) // batch_size) * batch_size if drop_last else len(order)
    for start in range(0, usable, batch_size):
        examples = [dataset.example(int(i))
                    for i in order[start:start + batch_size]]
        yield {k: np.stack([e[k] for e in examples]) for k in examples[0]}


class PrefetchIterator:
    """Batches made on a background thread while the device steps (the
    reference's DataLoader(num_workers=4)): up to ``prefetch`` wait in a
    queue. An exception in the worker is raised by the next ``next()``
    after the batches made before it."""

    def __init__(self, iterable, prefetch: int = 2):
        import queue
        import threading

        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._sentinel = object()
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in iterable:
                    self._queue.put(item)
            except Exception as e:  # raised by the consumer's next()
                self._err = e
            finally:
                self._queue.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
