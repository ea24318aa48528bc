"""Reference checkpoints -> the port's state dicts (the counterparts of
``ullsam_tpu/convert/torch_sam.py``, ``torch_internlm2.py`` and
``torch_fusion.py``, which build JAX trees from the same files).

The port keeps the reference's parameter names and layouts, so converting
is renaming:
  * SAM ``.pth`` (``image_encoder.`` / ``prompt_encoder.`` /
    ``mask_decoder.``; a uLLSAM file's tower under ``vision_model.``) ->
    ``models.sam.sam.Sam``'s names;
  * InternLM2 (HF safetensors shards or a ``.pt``, keys under ``prefix``)
    -> ``InternLM2ForCausalLM``'s (``model.*``, ``output.*``);
  * uLLSAM ``.pt`` (``vision_model.``, ``language_model.``, ``mlp1.``,
    ``mlp2.``, ``prompt_encoder.``, ``mask_decoder.`` under one prefix,
    perhaps wrapped in DDP's ``module.``) -> ``ULLSAM``'s, which put
    ``fusion.`` before the first four.
SAM files lack the uLLSAM prompt-encoder extension; as in the JAX
converter it defaults to llm_scale_factor 0.1 and llm_bias 0. Keys and
shapes are checked where a module loads them
(``convert.from_jax.load_reference_state_dict``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

Tensors = Dict[str, torch.Tensor]

_FUSION_PARTS = ("vision_model.", "language_model.", "mlp1.", "mlp2.")
_SAM_PARTS = ("prompt_encoder.", "mask_decoder.")


def load_torch_state_dict(path: str) -> Tensors:
    """A reference ``.pth`` / ``.pt`` on the host; a training checkpoint's
    {"model": state_dict} wrapper is unwrapped. The file is unpickled in
    full (reference checkpoints carry their argparse namespace): load
    trusted files only."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def strip_module_prefix(sd: Mapping[str, torch.Tensor]) -> Tensors:
    """Remove DDP's ``module.`` wrapper where present."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _llm_ext_defaults(out: Tensors) -> Tensors:
    out.setdefault("prompt_encoder.llm_scale_factor",
                   torch.full((1,), 0.1))
    out.setdefault("prompt_encoder.llm_bias", torch.zeros(1))
    return out


def convert_sam_state_dict(sd: Mapping[str, torch.Tensor]) -> Tensors:
    """A SAM (or uLLSAM) state dict -> ``Sam``'s names: the tower's
    ``vision_model.`` becomes ``image_encoder.`` where the file has no
    ``image_encoder.``."""
    sd = strip_module_prefix(sd)
    vision = ("image_encoder." if any(k.startswith("image_encoder.")
                                      for k in sd) else "vision_model.")
    out = {"image_encoder." + k[len(vision):]: v for k, v in sd.items()
           if k.startswith(vision)}
    out.update({k: v for k, v in sd.items() if k.startswith(_SAM_PARTS)})
    return _llm_ext_defaults(out)


def convert_internlm2_state_dict(sd: Mapping[str, torch.Tensor],
                                 prefix: str = "") -> Tensors:
    """The keys under ``prefix`` with it stripped: ``InternLM2ForCausalLM``'s
    names."""
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def load_internlm2_safetensors(model_dir: str, prefix: str = "") -> Tensors:
    """Every ``*.safetensors`` shard of an HF model directory merged, then
    ``convert_internlm2_state_dict``. Imports ``safetensors`` here."""
    import glob
    import os

    from safetensors.torch import load_file

    sd: Tensors = {}
    for shard in sorted(glob.glob(os.path.join(model_dir, "*.safetensors"))):
        sd.update(load_file(shard))
    return convert_internlm2_state_dict(sd, prefix)


def convert_fusion_state_dict(sd: Mapping[str, torch.Tensor],
                              prefix: str = "") -> Tensors:
    """A uLLSAM state dict (keys under ``prefix``) -> ``ULLSAM``'s names."""
    sd = strip_module_prefix(sd)
    out: Tensors = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if k.startswith(_FUSION_PARTS):
            out["fusion." + k] = v
        elif k.startswith(_SAM_PARTS):
            out[k] = v
    return _llm_ext_defaults(out)
