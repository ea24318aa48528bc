"""The port's host data pipeline (``ullsam_tpu_torch/data/``) against
``ullsam_tpu.data``: point sampling on masks that reach each fallback
branch, the pretrain / SFT / segmentation examples of a synthetic PNG set
(missing images skipped), the sharded batch order and the prefetch
thread's errors. All of it is numpy on the host, so everything is bitwise.
"""

import json
import os

import numpy as np
import pytest

from torch_port_helpers import StubTokenizer, write_synthetic_dataset

from ullsam_tpu.data import datasets as JD
from ullsam_tpu.data import point_sampling as JP
from ullsam_tpu_torch.data import datasets as TD
from ullsam_tpu_torch.data import point_sampling as TP


def _masks():
    """name -> (mask, num_pos): each reaches another branch."""
    big = np.zeros((64, 64), bool)
    big[10:50, 12:44] = True            # interior and band: both sampled
    thin = np.zeros((64, 64), bool)
    thin[22:43, 22:43] = True           # interior of 1 pixel < num_pos 2
    tiny = np.zeros((64, 64), bool)
    tiny[30:33, 30:33] = True           # no interior: the centroid
    dot = np.zeros((13, 13), bool)
    dot[6, 6] = True                    # no band: beyond the dilation
    block = np.zeros((13, 13), bool)
    block[5:8, 5:8] = True              # neither: rejection sampling
    empty = np.zeros((20, 24), bool)    # the image centre
    return {"big": (big, 2), "thin": (thin, 2), "tiny": (tiny, 1),
            "dot": (dot, 1), "block": (block, 1), "empty": (empty, 1)}


@pytest.mark.parametrize("name", list(_masks()))
def test_point_sampling_is_jax_bitwise(name):
    mask, num_pos = _masks()[name]
    for seed in range(3):
        ref = JP.sample_instance_points(mask, np.random.default_rng(seed),
                                        num_pos=num_pos, num_neg=3)
        got = TP.sample_instance_points(mask, np.random.default_rng(seed),
                                        num_pos=num_pos, num_neg=3)
        for r, g in zip(ref, got):
            assert r.dtype == g.dtype
            np.testing.assert_array_equal(g, r)


def _same_example(ref: dict, got: dict):
    assert set(ref) == set(got)
    for k in ref:
        assert ref[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _with_missing_row(jsonl, key):
    """Append a row whose image does not exist (both packages skip it)."""
    with open(jsonl, "a") as f:
        f.write(json.dumps({key: "/nonexistent/none.png",
                            "conversation": [], "conversations": []}) + "\n")


@pytest.mark.parametrize("kind", ["pretrain", "sft", "seg"])
def test_dataset_examples_are_jax_bitwise(tmp_path, kind):
    """Every example of PretrainDataset / SFTDataset / SegDataset, and
    SegDataset with an explicit seed; a row with a missing image is
    skipped; labels are -100 before the assistant turn, on padding and on
    <IMG_CONTEXT>."""
    jsonl = write_synthetic_dataset(str(tmp_path), n=4,
                                    pretrain=kind == "pretrain")
    _with_missing_row(jsonl, "image" if kind == "pretrain" else "image_path")
    tk = StubTokenizer()
    cls = {"pretrain": "PretrainDataset", "sft": "SFTDataset",
           "seg": "SegDataset"}[kind]
    kw = dict(data_path=jsonl, max_length=160, img_size=64,
              num_image_token=16, sam_max_point_bs=4)
    jds = getattr(JD, cls)(JD.DatasetConfig(**kw), tk)
    tds = getattr(TD, cls)(TD.DatasetConfig(**kw), tk)
    assert len(tds) == len(jds) == 4
    assert tds.assistant_marker == jds.assistant_marker
    for i in range(4):
        ex = tds.example(i)
        _same_example(jds.example(i), ex)
        lab = ex["labels"]
        assert (lab[ex["attention_mask"] == 0] == -100).all()
        assert (lab[ex["input_ids"] == 92546] == -100).all()
        assert (lab != -100).sum() > 0 and lab[0] == -100
    if kind == "seg":
        _same_example(jds.example(1, seed=7), tds.example(1, seed=7))
        ex = tds.example(0)
        assert ex["instance_valid"].tolist() == [1, 1, 1, 0]
        assert ex["masks"].shape == (4, 64, 64)


def test_batch_iterator_order_and_shards(tmp_path):
    """The shuffled order per epoch, each process's share, drop_last, and
    the stacked batches."""
    jsonl = write_synthetic_dataset(str(tmp_path), n=5)
    tk = StubTokenizer()
    kw = dict(data_path=jsonl, max_length=160, img_size=64,
              num_image_token=16, sam_max_point_bs=2)
    jds = JD.SegDataset(JD.DatasetConfig(**kw), tk)
    tds = TD.SegDataset(TD.DatasetConfig(**kw), tk)
    for opts in (dict(process_index=0, process_count=2, epoch=1),
                 dict(process_index=1, process_count=2, epoch=1),
                 dict(shuffle=False, drop_last=False),
                 dict(seed=3, epoch=2)):
        ref = list(JD.batch_iterator_sharded(jds, 2, **opts))
        got = list(TD.batch_iterator_sharded(tds, 2, **opts))
        assert len(got) == len(ref) > 0
        for r, g in zip(ref, got):
            _same_example(r, g)


def test_prefetch_iterator_raises_the_workers_error():
    assert list(TD.PrefetchIterator(iter(range(7)), prefetch=3)) == list(
        range(7))

    def boom():
        yield 1
        yield 2
        raise ValueError("boom")

    it = TD.PrefetchIterator(boom())
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_instance_map_reader_and_packing_reexports(tmp_path):
    """``load_instance_map`` reads what SegDataset reads; the packing
    helpers are the ones of ``data/packing.py``."""
    from ullsam_tpu_torch.data import packing

    write_synthetic_dataset(str(tmp_path), n=1, img_size=64)
    m = TD.load_instance_map(os.path.join(tmp_path, "masks", "0.png"), 32)
    assert m.shape == (32, 32) and set(np.unique(m)) <= {0, 1, 2, 3}
    assert TD.pack_examples is packing.pack_examples
    assert (TD.packed_batch_iterator_sharded
            is packing.packed_batch_iterator_sharded)
