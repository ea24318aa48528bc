"""The port's evaluation CLI (``python -m ullsam_tpu_torch.eval.cli``)
against the JAX one (``ullsam_tpu.eval.cli``) on one reference-layout
checkpoint of the ``--tiny`` model, one synthetic PNG dataset and one stub
tokenizer, in the modes ``seg`` (with and without ``--baseline``),
``seg_amg`` and ``lm``.

Per image: the pixel metrics (foreground IoU, Dice, precision, recall) and
the mean matched IoU within 1e-4, the prediction and ground-truth counts
equal; the AP values are step functions of the masks' IoUs, so they may
differ only where a mask pixel flips. A flipped pixel moves the pixel
metrics by at least 1 / (mask area), far above 1e-4, so here, where those
agree, the AP values are held equal. ``lm``: each image's NLL within
rtol 1e-5 (f32, another summation order).

At random weights the production thresholds of ``seg_amg`` (predicted IoU
0.88, stability 0.95) commit no mask on either side, so its AP compares
empty sets; the generator the CLI builds on the model (``sam_of``) is
therefore also held to JAX's with the thresholds off: the same records,
areas and predicted IoUs (1e-5), masks equal on 99.9% of pixels.
"""

import json
import os

import numpy as np
import pytest

from test_torch_train_cli import write_fusion_checkpoint
from torch_port_helpers import patch_tokenizers, write_synthetic_dataset

from ullsam_tpu.eval import cli as JE
from ullsam_tpu_torch.eval import cli as TE

MODES = {"seg": ["--mode", "seg"], "baseline": ["--mode", "seg", "--baseline"],
         "seg_amg": ["--mode", "seg_amg"], "lm": ["--mode", "lm"]}
PIXEL = ("pixel_iou", "dice", "precision", "recall", "mean_matched_iou")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cli")
    data = write_synthetic_dataset(str(root / "data"), n=3, n_inst=4)
    ckpt = str(root / "ullsam.pt")
    write_fusion_checkpoint(ckpt, seed=3)
    out = {"root": root, "data": data, "ckpt": ckpt}
    with pytest.MonkeyPatch.context() as mp:
        patch_tokenizers(mp)
        for name, flags in MODES.items():
            path = str(root / f"jax_{name}.json")
            JE.main(flags + ["--tiny", "--limit", "2", "--data_path", data,
                             "--checkpoint", ckpt, "--output", path])
            out[name] = path
    return out


@pytest.mark.parametrize("name", list(MODES))
def test_eval_matches_jax(jax_runs, monkeypatch, name):
    patch_tokenizers(monkeypatch)
    path = str(jax_runs["root"] / f"port_{name}.json")
    summary = TE.main(MODES[name] + [
        "--tiny", "--limit", "2", "--data_path", jax_runs["data"],
        "--checkpoint", jax_runs["ckpt"], "--output", path,
        "--device", "cpu"])
    with open(path) as f:
        got = json.load(f)
    with open(jax_runs[name]) as f:
        ref = json.load(f)
    assert got["summary"] == summary
    assert len(got["per_image"]) == len(ref["per_image"]) == 2
    for g, r in zip(got["per_image"], ref["per_image"]):
        assert set(g) == set(r)
        if name == "lm":
            np.testing.assert_allclose(g["nll"], r["nll"], rtol=1e-5)
            np.testing.assert_allclose(g["ppl"], r["ppl"], rtol=1e-4)
            continue
        assert (g["n_pred"], g["n_gt"]) == (r["n_pred"], r["n_gt"])
        for k in PIXEL:
            np.testing.assert_allclose(g[k], r[k], atol=1e-4, err_msg=k)
        assert (g["map"], g["ap50"]) == (r["map"], r["ap50"])
    for k, v in summary.items():
        assert np.isfinite(v), k
    if name.startswith("seg") or name == "baseline":
        assert got["per_image"][0]["n_gt"] == 4


def test_eval_refuses_cuda_without_a_card(jax_runs, monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    patch_tokenizers(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.main(["--tiny", "--data_path", jax_runs["data"]])
    assert not os.path.exists(str(jax_runs["root"] / "none.json"))


def test_cli_mask_generator_matches_jax_unthresholded(jax_runs):
    from PIL import Image

    from ullsam_tpu.convert.torch_fusion import convert_fusion_state_dict
    from ullsam_tpu.convert.torch_sam import load_torch_state_dict
    from ullsam_tpu.inference.amg import AutomaticMaskGenerator as JAMG
    from ullsam_tpu.train.cli import make_configs as jax_configs
    from ullsam_tpu_torch.convert import reference as R
    from ullsam_tpu_torch.convert.from_jax import load_reference_state_dict
    from ullsam_tpu_torch.inference.amg import AutomaticMaskGenerator as TAMG
    from ullsam_tpu_torch.models.ullsam import fusion as TF
    from ullsam_tpu_torch.train.cli import build_parser, make_configs

    args = build_parser().parse_args(["--tiny", "--data_path", "x"])
    tcfg, jcfg = make_configs(args), jax_configs(args)
    model = TF.ULLSAM(tcfg, device="cpu")
    load_reference_state_dict(model, R.convert_fusion_state_dict(
        R.load_torch_state_dict(jax_runs["ckpt"])))
    jp = convert_fusion_state_dict(load_torch_state_dict(jax_runs["ckpt"]),
                                   jcfg)
    root = os.path.dirname(jax_runs["data"])
    img = np.asarray(Image.open(os.path.join(root, "images", "0.png"))
                     .convert("RGB"))
    kw = dict(points_per_side=16, pred_iou_thresh=0.0,
              stability_score_thresh=0.0)
    ref = JAMG(jcfg.sam, jp["sam"], **kw).generate(img)
    got = TAMG(tcfg.sam, TE.sam_of(model), **kw).generate(img)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g["area"] == r["area"]
        np.testing.assert_allclose(g["predicted_iou"], r["predicted_iou"],
                                   atol=1e-5)
        assert (g["segmentation"] == r["segmentation"]).mean() >= 0.999
