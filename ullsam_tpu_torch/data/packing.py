"""Packed rows for the language-only training modes (``--pack``): several
tokenized samples share one row, told apart by segment ids (1..k, 0 =
padding). The port's own numpy copy of ``pack_examples`` and
``packed_batch_iterator_sharded`` (``ullsam_tpu/data/datasets.py:248-338``),
whose package imports jax.

An example is a dict of numpy arrays: ``input_ids`` [L], ``attention_mask``
[L] (its sum is the sample's length), ``labels`` [L] and optionally
``pixel_values`` [S, S, 3]. A dataset has ``len()`` and ``example(i)``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

Arrays = Dict[str, np.ndarray]


def pack_examples(examples: List[Arrays], max_length: int,
                  pad_token_id: int) -> Arrays:
    """One [1, max_length] row of ``examples`` back to back: input_ids,
    segment_ids (sample i has id i + 1, the tail 0) and labels (-100 on the
    tail), plus pixel_values [k, ...] stacked in token-stream order when the
    examples carry images. The examples must fit max_length together."""
    ids = np.full((max_length,), pad_token_id, np.int32)
    seg = np.zeros((max_length,), np.int32)
    lab = np.full((max_length,), -100, np.int32)
    pixels = []
    off = 0
    for s, e in enumerate(examples, start=1):
        n = int(e["attention_mask"].sum())
        if off + n > max_length:
            raise ValueError(f"pack_examples: examples overflow "
                             f"max_length={max_length}")
        ids[off:off + n] = e["input_ids"][:n]
        seg[off:off + n] = s
        lab[off:off + n] = e["labels"][:n]
        if "pixel_values" in e:
            pixels.append(e["pixel_values"])
        off += n
    out = {"input_ids": ids[None], "segment_ids": seg[None],
           "labels": lab[None]}
    if pixels:
        out["pixel_values"] = np.stack(pixels)
    return out


def packed_batch_iterator_sharded(dataset, rows_per_batch: int,
                                  max_length: int, pad_token_id: int, *,
                                  docs_per_row: int = 2,
                                  shuffle: bool = True, seed: int = 0,
                                  process_index: int = 0,
                                  process_count: int = 1,
                                  epoch: int = 0) -> Iterator[Arrays]:
    """Batches of ``rows_per_batch`` rows of exactly ``docs_per_row``
    samples each (fixed shapes). This process takes every
    ``process_count``-th sample of the (seeded) order from
    ``process_index``. A sample that does not fit the current row waits
    for a fresh one; a sample longer than max_length is dropped and
    counted. pixel_values carries the images of all rows' samples, row by
    row (the order ``scatter_image_embeds`` consumes them)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    order = order[process_index::process_count]

    rows, cur, cur_len, dropped = [], [], 0, 0
    pending = []  # samples that overflowed a partly filled row
    idx_iter = iter(order)
    while True:
        # a pending sample fits max_length alone: it may always start a
        # fresh row, so pending ones go first whenever the row is empty
        if pending and not cur:
            e = pending.pop(0)
        else:
            i = next(idx_iter, None)
            if i is None:
                if pending and not cur:
                    continue
                break
            e = dataset.example(int(i))
        ln = int(e["attention_mask"].sum())
        if ln > max_length:
            dropped += 1
            continue
        if cur_len + ln > max_length:
            pending.append(e)
            continue
        cur.append(e)
        cur_len += ln
        if len(cur) == docs_per_row:
            rows.append(cur)
            cur, cur_len = [], 0
        if len(rows) == rows_per_batch:
            packed = [pack_examples(r, max_length, pad_token_id)
                      for r in rows]
            batch = {k: np.concatenate([p[k] for p in packed])
                     for k in ("input_ids", "segment_ids", "labels")}
            pix = [p["pixel_values"] for p in packed if "pixel_values" in p]
            if pix:
                batch["pixel_values"] = np.concatenate(pix)
            yield batch
            rows = []
    if dropped:
        print(f"[pack] dropped {dropped} samples that overflowed "
              f"max_length={max_length}")
