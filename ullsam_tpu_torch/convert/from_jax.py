"""Weights carried across from the JAX package.

``fusion_state_dict_from_jax(params_np, cfg)`` maps the JAX fusion param
pytree (as numpy arrays) to this package's state dict under the reference
checkpoint names; ``sam_state_dict_from_jax(params_np, cfg)`` does the same
for a standalone SAM (``sam_init`` / ``build_sam`` params). They are the
inverse of ``ullsam_tpu/convert/torch_sam.py`` and ``torch_internlm2.py``:

  * Linear kernel [in, out]              -> weight [out, in]
  * Conv kernel HWIO                     -> weight OIHW
  * ConvTranspose kernel [kh, kw, I, O]  -> weight [I, O, kh, kw]
  * stacked LLM layers [L, ...]          -> model.layers.{i}.*
  * int8 LLM qweight [.., in, out]       -> qweight [out, in] (+ qscale)

``internvit_state_dict_from_jax`` does it for the JAX InternViT tower.
``load_reference_state_dict`` loads a reference-named state dict (such as
the golden fixtures) into a module as it is. ``jax_param_arrays`` goes the
other way, a ``ULLSAM``'s parameters to the JAX package's flat param paths
and layouts; ``unflatten_paths`` makes a flat dict of such paths a tree
for ``fusion_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ullsam_tpu_torch.core.config import (FusionConfig, InternLM2Config,
                                          MaskDecoderConfig, SamConfig)

Arrays = Dict[str, np.ndarray]


def _lin(out: Arrays, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])


def _conv(out: Arrays, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])


def _convt(out: Arrays, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)
    out[f"{name}.bias"] = np.asarray(p["bias"])


def _ln(out: Arrays, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = np.asarray(p["scale"])
    out[f"{name}.bias"] = np.asarray(p["bias"])


def image_encoder_arrays(p: Mapping, prefix: str) -> Arrays:
    out: Arrays = {}
    _conv(out, f"{prefix}patch_embed.proj", p["patch_embed"])
    if "pos_embed" in p:
        out[f"{prefix}pos_embed"] = np.asarray(p["pos_embed"])
    for i, b in enumerate(p["blocks"]):
        n = f"{prefix}blocks.{i}."
        _ln(out, n + "norm1", b["norm1"])
        _lin(out, n + "attn.qkv", b["attn"]["qkv"])
        _lin(out, n + "attn.proj", b["attn"]["proj"])
        for r in ("rel_pos_h", "rel_pos_w"):
            if r in b["attn"]:
                out[n + "attn." + r] = np.asarray(b["attn"][r])
        _ln(out, n + "norm2", b["norm2"])
        _lin(out, n + "mlp.lin1", b["mlp"]["fc1"])
        _lin(out, n + "mlp.lin2", b["mlp"]["fc2"])
    neck = p["neck"]
    _conv(out, f"{prefix}neck.0", neck["conv1"])
    _ln(out, f"{prefix}neck.1", neck["ln1"])
    _conv(out, f"{prefix}neck.2", neck["conv2"])
    _ln(out, f"{prefix}neck.3", neck["ln2"])
    return out


def prompt_encoder_arrays(p: Mapping, prefix: str = "prompt_encoder."
                          ) -> Arrays:
    out: Arrays = {
        f"{prefix}pe_layer.positional_encoding_gaussian_matrix":
            np.asarray(p["pe_gaussian"]),
        f"{prefix}not_a_point_embed.weight": np.asarray(p["not_a_point"])[None],
        f"{prefix}no_mask_embed.weight": np.asarray(p["no_mask"])[None],
        f"{prefix}llm_scale_factor": np.asarray(p["llm_scale"]),
        f"{prefix}llm_bias": np.asarray(p["llm_bias"]),
    }
    for i in range(4):
        out[f"{prefix}point_embeddings.{i}.weight"] = \
            np.asarray(p["point_embeds"])[i:i + 1]
    md = p["mask_downscaling"]
    _conv(out, f"{prefix}mask_downscaling.0", md["conv1"])
    _ln(out, f"{prefix}mask_downscaling.1", md["ln1"])
    _conv(out, f"{prefix}mask_downscaling.3", md["conv2"])
    _ln(out, f"{prefix}mask_downscaling.4", md["ln2"])
    _conv(out, f"{prefix}mask_downscaling.6", md["conv3"])
    return out


def mask_decoder_arrays(p: Mapping, cfg: MaskDecoderConfig,
                        prefix: str = "mask_decoder.") -> Arrays:
    out: Arrays = {f"{prefix}iou_token.weight": np.asarray(p["iou_token"]),
                   f"{prefix}mask_tokens.weight": np.asarray(p["mask_tokens"])}

    def attn(name: str, a: Mapping) -> None:
        for src, dst in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("out", "out_proj")):
            _lin(out, f"{name}.{dst}", a[src])

    t = p["transformer"]
    for i, layer in enumerate(t["layers"]):
        n = f"{prefix}transformer.layers.{i}."
        attn(n + "self_attn", layer["self_attn"])
        attn(n + "cross_attn_token_to_image", layer["cross_attn_t2i"])
        attn(n + "cross_attn_image_to_token", layer["cross_attn_i2t"])
        for k in ("norm1", "norm2", "norm3", "norm4"):
            _ln(out, n + k, layer[k])
        _lin(out, n + "mlp.lin1", layer["mlp"]["fc1"])
        _lin(out, n + "mlp.lin2", layer["mlp"]["fc2"])
    attn(f"{prefix}transformer.final_attn_token_to_image",
         t["final_attn_t2i"])
    _ln(out, f"{prefix}transformer.norm_final_attn", t["norm_final"])
    up = p["upscale"]
    _convt(out, f"{prefix}output_upscaling.0", up["convt1"])
    _ln(out, f"{prefix}output_upscaling.1", up["ln"])
    _convt(out, f"{prefix}output_upscaling.3", up["convt2"])
    for i in range(cfg.num_mask_tokens):
        for j, lp in enumerate(p["hyper_mlps"][i]["layers"]):
            _lin(out, f"{prefix}output_hypernetworks_mlps.{i}.layers.{j}", lp)
    for j, lp in enumerate(p["iou_head"]["layers"]):
        _lin(out, f"{prefix}iou_prediction_head.layers.{j}", lp)
    return out


def _llm_lin(out: Arrays, name: str, p: Mapping, i=None) -> None:
    """A JAX LLM linear (layer ``i`` of a stacked one) -> ``name.weight``
    [out, in], or, quantized (``quantize_llm_int8``), ``name.qweight``
    [out, in] int8 and ``name.qscale``; the bias as it is."""
    def take(a):
        a = np.asarray(a)
        return a if i is None else a[i]

    if "qweight" in p:
        out[f"{name}.qweight"] = take(p["qweight"]).T
        out[f"{name}.qscale"] = take(p["qscale"])
    else:
        out[f"{name}.weight"] = take(p["kernel"]).T
    if "bias" in p:
        out[f"{name}.bias"] = take(p["bias"])


def internlm2_arrays(p: Mapping, cfg: InternLM2Config,
                     prefix: str = "") -> Arrays:
    """The InternLM2 tree, full precision or quantized (a quantized tree
    loads into a model after ``models/internlm2/quant.quantize_llm_int8``)."""
    out: Arrays = {
        f"{prefix}model.tok_embeddings.weight":
            np.asarray(p["tok_embeddings"]),
        f"{prefix}model.norm.weight": np.asarray(p["norm"]["scale"]),
    }
    _llm_lin(out, f"{prefix}output", p["output"])
    lay = p["layers"]
    for i in range(cfg.num_hidden_layers):
        n = f"{prefix}model.layers.{i}."
        out[n + "attention_norm.weight"] = np.asarray(
            lay["attention_norm"]["scale"][i])
        out[n + "ffn_norm.weight"] = np.asarray(lay["ffn_norm"]["scale"][i])
        for src, dst in (("wqkv", "attention.wqkv"), ("wo", "attention.wo"),
                         ("w1", "feed_forward.w1"), ("w3", "feed_forward.w3"),
                         ("w2", "feed_forward.w2")):
            _llm_lin(out, n + dst, lay[src], i)
    return out


def _proj_mlp_arrays(p: Mapping, prefix: str) -> Arrays:
    out: Arrays = {}
    _ln(out, f"{prefix}0", p["ln"])
    _lin(out, f"{prefix}1", p["fc1"])
    _lin(out, f"{prefix}3", p["fc2"])
    return out


def _tensors(arrays: Arrays) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in arrays.items()}


def sam_state_dict_from_jax(params_np: Mapping, cfg: SamConfig
                            ) -> Dict[str, torch.Tensor]:
    """JAX SAM params {'image_encoder', 'prompt_encoder', 'mask_decoder'}
    (numpy leaves) -> the state dict of ``models.sam.sam.Sam``."""
    arrays = image_encoder_arrays(params_np["image_encoder"],
                                  "image_encoder.")
    arrays.update(prompt_encoder_arrays(params_np["prompt_encoder"]))
    arrays.update(mask_decoder_arrays(params_np["mask_decoder"],
                                      cfg.mask_decoder))
    return _tensors(arrays)


def fusion_state_dict_from_jax(params_np: Mapping, cfg: FusionConfig
                               ) -> Dict[str, torch.Tensor]:
    """JAX fusion params {'sam', 'llm', 'mlp1', 'mlp2'} (numpy leaves) ->
    the state dict of ``ULLSAM``."""
    sam = params_np["sam"]
    arrays: Arrays = {}
    arrays.update(image_encoder_arrays(sam["image_encoder"],
                                       "fusion.vision_model."))
    arrays.update(prompt_encoder_arrays(sam["prompt_encoder"]))
    arrays.update(mask_decoder_arrays(sam["mask_decoder"],
                                      cfg.sam.mask_decoder))
    arrays.update(internlm2_arrays(params_np["llm"], cfg.llm,
                                   "fusion.language_model."))
    arrays.update(_proj_mlp_arrays(params_np["mlp1"], "fusion.mlp1."))
    arrays.update(_proj_mlp_arrays(params_np["mlp2"], "fusion.mlp2."))
    return _tensors(arrays)


def internvit_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``internvit_init`` tree (numpy leaves) -> the state dict of
    ``models.internvit.model.InternViT``."""
    out: Arrays = {"cls_token": np.asarray(params["cls_token"]),
                   "pos_embed": np.asarray(params["pos_embed"])}
    _conv(out, "patch_embed", params["patch_embed"])
    for i, b in enumerate(params["blocks"]):
        n = f"blocks.{i}."
        _ln(out, n + "norm1", b["norm1"])
        _ln(out, n + "norm2", b["norm2"])
        _lin(out, n + "attn.qkv", b["attn"]["qkv"])
        _lin(out, n + "attn.proj", b["attn"]["proj"])
        for k in ("q_norm", "k_norm"):  # RMSNorm: a scale only
            if k in b["attn"]:
                out[f"{n}attn.{k}.weight"] = np.asarray(b["attn"][k]["scale"])
        _lin(out, n + "mlp.lin1", b["mlp"]["fc1"])
        _lin(out, n + "mlp.lin2", b["mlp"]["fc2"])
        out[n + "ls1"] = np.asarray(b["ls1"])
        out[n + "ls2"] = np.asarray(b["ls2"])
    return _tensors(out)


def load_reference_state_dict(module: nn.Module, arrays: Mapping,
                              prefix: str = "") -> nn.Module:
    """Load the ``prefix``-named entries of a reference state dict (numpy
    arrays or tensors, any float dtype; other keys ignored) into
    ``module``, in the module's dtype and device. Every parameter and
    buffer of the module must be present."""
    own = module.state_dict()
    sd = {}
    for name, ref in own.items():
        key = prefix + name
        if key not in arrays:
            raise KeyError(f"reference state dict has no {key!r}")
        v = arrays[key]
        v = v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
        sd[name] = v.to(dtype=ref.dtype, device=ref.device)
    module.load_state_dict(sd, strict=True)
    return module


# ---------------------------------------------------------------------------
# torch parameter name -> JAX param path
# ---------------------------------------------------------------------------

# module-path renames, applied in order to the dotted module path of a
# parameter (the inverse of the converters above)
_MODULE_RENAMES = (
    (r"^fusion\.vision_model\b", "sam.image_encoder"),
    (r"^prompt_encoder\b", "sam.prompt_encoder"),
    (r"^mask_decoder\b", "sam.mask_decoder"),
    (r"^fusion\.language_model\b", "llm"),
    (r"^fusion\.(mlp[12])\.0$", r"\1.ln"),
    (r"^fusion\.(mlp[12])\.1$", r"\1.fc1"),
    (r"^fusion\.(mlp[12])\.3$", r"\1.fc2"),
    (r"\.patch_embed\.proj$", ".patch_embed"),
    (r"\.mlp\.lin1$", ".mlp.fc1"),
    (r"\.mlp\.lin2$", ".mlp.fc2"),
    (r"\.neck\.0$", ".neck.conv1"), (r"\.neck\.1$", ".neck.ln1"),
    (r"\.neck\.2$", ".neck.conv2"), (r"\.neck\.3$", ".neck.ln2"),
    (r"\.pe_layer$", ""),
    (r"\.point_embeddings\.\d+$", ".point_embeds"),
    (r"\.not_a_point_embed$", ".not_a_point"),
    (r"\.no_mask_embed$", ".no_mask"),
    (r"\.mask_downscaling\.0$", ".mask_downscaling.conv1"),
    (r"\.mask_downscaling\.1$", ".mask_downscaling.ln1"),
    (r"\.mask_downscaling\.3$", ".mask_downscaling.conv2"),
    (r"\.mask_downscaling\.4$", ".mask_downscaling.ln2"),
    (r"\.mask_downscaling\.6$", ".mask_downscaling.conv3"),
    (r"\.cross_attn_token_to_image\b", ".cross_attn_t2i"),
    (r"\.cross_attn_image_to_token\b", ".cross_attn_i2t"),
    (r"\.final_attn_token_to_image\b", ".final_attn_t2i"),
    (r"\.norm_final_attn$", ".norm_final"),
    (r"\.(q|k|v|out)_proj$", r".\1"),
    (r"\.output_upscaling\.0$", ".upscale.convt1"),
    (r"\.output_upscaling\.1$", ".upscale.ln"),
    (r"\.output_upscaling\.3$", ".upscale.convt2"),
    (r"\.output_hypernetworks_mlps\.", ".hyper_mlps."),
    (r"\.iou_prediction_head\.", ".iou_head."),
    (r"^llm\.model\.layers\.\d+\.(attention\.|feed_forward\.)?", "llm.layers."),
    (r"^llm\.model\.", "llm."),
)
_LEAF_RENAMES = {"positional_encoding_gaussian_matrix": "pe_gaussian",
                 "llm_scale_factor": "llm_scale"}


def jax_param_paths(model: nn.Module) -> Dict[str, str]:
    """{torch parameter name: the dotted path of the same leaf in the JAX
    package's param tree} for a ``ULLSAM``, e.g. ``fusion.vision_model.
    neck.1.weight`` -> ``sam.image_encoder.neck.ln1.scale``. Stacked JAX
    leaves (the LLM's layers, the prompt encoder's ``point_embeds``) take
    several torch names. JAX's path regexes (trainable, no-decay) are
    matched against these paths."""
    import re
    from ullsam_tpu_torch.ops import layers as L

    out = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            path = mname
            for pat, rep in _MODULE_RENAMES:
                path = re.sub(pat, rep, path)
            if isinstance(mod, (L.LayerNorm, L.RMSNorm)):
                leaf = {"weight": "scale"}.get(pname, pname)
            elif isinstance(mod, (L.Linear, L.Conv2d, L.ConvTranspose2x2)):
                leaf = {"weight": "kernel"}.get(pname, pname)
            elif isinstance(mod, L.Embedding):
                leaf = None
            else:
                leaf = _LEAF_RENAMES.get(pname, pname)
            out[f"{mname}.{pname}" if mname else pname] = (
                path if leaf is None else f"{path}.{leaf}")
    return out


def jax_param_arrays(model: nn.Module) -> Arrays:
    """{JAX param path: array in the JAX layout} of a ``ULLSAM`` (floats as
    float32): the flattened tree that ``fusion_state_dict_from_jax`` maps
    back to the same parameters. Linear kernels [in, out], convolutions
    HWIO, transposed convolutions [kh, kw, I, O], the LLM's layers stacked
    on a leading axis, the prompt encoder's point embeddings stacked and
    its single-row embeddings as vectors."""
    from ullsam_tpu_torch.ops import layers as L

    paths = jax_param_paths(model)
    mods = dict(model.named_modules())
    groups: Dict[str, list] = {}
    for name, p in model.named_parameters():
        a = p.detach().cpu()
        a = (a.float() if a.is_floating_point() else a).numpy()
        mname, leaf = name.rpartition(".")[::2]
        mod = mods[mname]
        if leaf == "weight" and isinstance(mod, L.Linear):
            a = a.T
        elif leaf == "weight" and isinstance(mod, L.Conv2d):
            a = a.transpose(2, 3, 1, 0)
        elif leaf == "weight" and isinstance(mod, L.ConvTranspose2x2):
            a = a.transpose(2, 3, 0, 1)
        groups.setdefault(paths[name], []).append(a)
    out: Arrays = {}
    for path, arrs in groups.items():
        if path.startswith("llm.layers."):  # named_parameters: layer order
            out[path] = np.stack(arrs)
        elif path.endswith(".point_embeds"):
            out[path] = np.concatenate(arrs)
        elif path.endswith((".not_a_point", ".no_mask")):
            out[path] = arrs[0][0]
        else:
            (out[path],) = arrs
        out[path] = np.ascontiguousarray(out[path])
    return out


def unflatten_paths(flat: Mapping[str, np.ndarray]) -> dict:
    """{dotted path: leaf} -> nested dicts, a level whose keys are all
    digits becoming a list (the JAX tree's block and layer lists)."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *heads, last = path.split(".")
        for k in heads:
            node = node.setdefault(k, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)
