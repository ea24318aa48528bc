"""The port's extras against the JAX package: the InternLM2 sequence
classification head (``tests/test_inventory_extras.py``'s computation, all
three losses), the InternViT tower (``internvit_apply``) and round trips of
the checkpoint converter CLI (``python -m ullsam_tpu_torch.convert.cli``)
against the JAX converters.

Tolerances: logits and losses 1e-5 relative to their scale (f32, another
summation order through the LLM); InternViT tokens within 1e-5 of max|out|;
converted weights bitwise (a rename and a layout change are exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (assert_close, jax_init, jax_params_to_numpy,
                                tiny_fusion_config)

from ullsam_tpu.core import config as JC
from ullsam_tpu_torch.convert.from_jax import (fusion_state_dict_from_jax,
                                               internlm2_arrays,
                                               internvit_state_dict_from_jax,
                                               sam_state_dict_from_jax)
from ullsam_tpu_torch.core import config as TC


@pytest.mark.parametrize("problem", ["single_label_classification",
                                     "multi_label_classification",
                                     "regression"])
def test_classification_head_matches_jax(problem):
    from ullsam_tpu.models.internlm2 import model as JM
    from ullsam_tpu.models.internlm2.classification import (
        classification_head_init, internlm2_classify)
    from ullsam_tpu_torch.models.internlm2 import classification as TCL
    from ullsam_tpu_torch.models.internlm2.model import InternLM2ForCausalLM

    jcfg, tcfg = JC.internlm2_tiny(), TC.internlm2_tiny()
    n_labels = 1 if problem == "regression" else 3
    params = jax_init(JM.internlm2_init, 0, jcfg)
    head = classification_head_init(jax.random.PRNGKey(1), jcfg, n_labels)
    lm = InternLM2ForCausalLM(tcfg, device="cpu")
    lm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                        internlm2_arrays(jax.tree_util.tree_map(
                            np.asarray, params), tcfg).items()})
    th = TCL.ClassificationHead(tcfg, n_labels, device="cpu")
    th.score.weight.data = torch.from_numpy(
        np.array(head["score"]["kernel"]).T.copy())
    ids = np.asarray([[5, 9, 11, 2, 2], [7, 23, 55, 4, 9]])
    mask = np.asarray([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]])
    labels = {"single_label_classification": np.asarray([0, 2]),
              "multi_label_classification": np.asarray([[1, 0, 1],
                                                        [0, 1, 1]]),
              "regression": np.asarray([0.5, -1.0], np.float32)}[problem]
    ref = internlm2_classify(params, head, jcfg, jnp.asarray(ids),
                             jnp.asarray(mask), labels=jnp.asarray(labels),
                             problem_type=problem)
    got = TCL.internlm2_classify(lm, th, tcfg, torch.from_numpy(ids),
                                 torch.from_numpy(mask),
                                 labels=torch.from_numpy(labels),
                                 problem_type=problem)
    scale = float(np.abs(np.asarray(ref["logits"])).max())
    assert_close(got["logits"], ref["logits"], atol=1e-5 * scale)
    np.testing.assert_allclose(float(got["loss"].detach()), float(ref["loss"]),
                               rtol=1e-5)
    # the padded row reads the hidden state at position 2, not 4
    short = TCL.internlm2_classify(lm, th, tcfg, torch.from_numpy(ids[:, :3]),
                                   torch.from_numpy(mask[:, :3]))
    assert_close(short["logits"][0], got["logits"][0], atol=1e-5 * scale)
    init = TCL.classification_head_init(tcfg, n_labels, seed=2, device="cpu")
    assert init.score.weight.abs().max() > 0 and init.score.bias is None


@pytest.mark.parametrize("qk_norm", [True, False])
def test_internvit_matches_jax(qk_norm):
    from ullsam_tpu.models.internvit import model as JV
    from ullsam_tpu_torch.models.internvit import model as TV

    kw = dict(patch_size=8, image_size=32, hidden_size=32,
              num_attention_heads=4, num_hidden_layers=2,
              intermediate_size=64, qk_normalization=qk_norm,
              qkv_bias=not qk_norm)
    jcfg, tcfg = JC.InternViTConfig(**kw), TC.InternViTConfig(**kw)
    rng = np.random.default_rng(0)
    p = jax_params_to_numpy(jax_init(JV.internvit_init, 0, jcfg), rng)
    p = jax.tree_util.tree_map(
        lambda a: a + rng.standard_normal(a.shape).astype(a.dtype) * 0.05, p)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    ref = JV.internvit_apply(p, jnp.asarray(x), jcfg)
    model = TV.InternViT(tcfg, device="cpu")
    model.load_state_dict(internvit_state_dict_from_jax(p))
    got = TV.internvit_apply(model, torch.from_numpy(x))
    assert got.shape == (2, 1 + 16, 32)
    assert_close(got, ref, atol=1e-5 * float(np.abs(np.asarray(ref)).max()))
    seeded = TV.internvit_init(tcfg, seed=1, device="cpu")
    assert seeded(torch.from_numpy(x)).isfinite().all()


def _save_reference(path, sd, prefix=""):
    torch.save({prefix + k: v for k, v in sd.items()}, path)


def test_convert_cli_round_trips_match_jax_converters(tmp_path):
    """Reference-layout files written from JAX parameters go through the
    port's convert CLI; what it writes loads into the port bitwise equal to
    ``*_state_dict_from_jax`` of the JAX converters' trees of the same
    files: a DDP-wrapped uLLSAM .pt, a SAM .pth and InternLM2 safetensors
    shards under ``language_model.``."""
    from safetensors.torch import save_file

    from ullsam_tpu.convert import torch_fusion as JTF
    from ullsam_tpu.convert import torch_internlm2 as JTI
    from ullsam_tpu.convert import torch_sam as JTS
    from ullsam_tpu.models.ullsam import fusion as JF
    from ullsam_tpu_torch.convert import cli as CCLI
    from ullsam_tpu_torch.models.internlm2.model import InternLM2ForCausalLM
    from ullsam_tpu_torch.models.sam.sam import Sam
    from ullsam_tpu_torch.models.ullsam import fusion as TF

    jcfg, tcfg = tiny_fusion_config(JC), tiny_fusion_config(TC)
    p = jax_params_to_numpy(jax_init(JF.fusion_init, 6, jcfg),
                            np.random.default_rng(6))
    full = fusion_state_dict_from_jax(p, tcfg)
    ref = {(k[len("fusion."):] if k.startswith("fusion.") else k): v
           for k, v in full.items()}

    def convert(kind, src, *flags):
        out = str(tmp_path / f"{kind}.pt")
        CCLI.main(["--kind", kind, "--input", src, "--output", out, *flags])
        return torch.load(out, weights_only=True)

    def same(module, sd, want):
        module.load_state_dict(sd)
        for n, t in module.state_dict().items():
            assert torch.equal(t, want[n]), n

    # uLLSAM, DDP-wrapped
    _save_reference(str(tmp_path / "ullsam.pt"), ref, "module.")
    sd = convert("fusion", str(tmp_path / "ullsam.pt"))
    jp = JTF.convert_fusion_state_dict(
        JTS.load_torch_state_dict(str(tmp_path / "ullsam.pt")), jcfg)
    same(TF.ULLSAM(tcfg, device="cpu"), sd,
         fusion_state_dict_from_jax(jp, tcfg))

    # SAM .pth (no uLLSAM prompt-encoder extension: 0.1 / 0 on both sides)
    sam_ref = {("image_encoder." + k[len("vision_model."):]
                if k.startswith("vision_model.") else k): v
               for k, v in ref.items()
               if k.startswith(("vision_model.", "prompt_encoder.",
                                "mask_decoder."))
               and not k.endswith(("llm_scale_factor", "llm_bias"))}
    _save_reference(str(tmp_path / "sam.pth"), sam_ref)
    sd = convert("sam", str(tmp_path / "sam.pth"))
    js = JTS.convert_sam_state_dict(
        JTS.load_torch_state_dict(str(tmp_path / "sam.pth")), jcfg.sam)
    same(Sam(tcfg.sam, device="cpu"), sd,
         sam_state_dict_from_jax(js, tcfg.sam))

    # InternLM2: two safetensors shards under language_model.
    llm = {k: v.contiguous() for k, v in ref.items()
           if k.startswith("language_model.")}
    names = sorted(llm)
    shard_dir = tmp_path / "hf"
    shard_dir.mkdir()
    save_file({k: llm[k] for k in names[::2]},
              str(shard_dir / "model-00001-of-00002.safetensors"))
    save_file({k: llm[k] for k in names[1::2]},
              str(shard_dir / "model-00002-of-00002.safetensors"))
    sd = convert("internlm2", str(shard_dir), "--prefix", "language_model.")
    jl = JTI.load_internlm2_safetensors(str(shard_dir), jcfg.llm,
                                        prefix="language_model.")
    want = {k: torch.from_numpy(np.array(v)) for k, v in
            internlm2_arrays(jl, tcfg.llm).items()}
    same(InternLM2ForCausalLM(tcfg.llm, device="cpu"), sd, want)
