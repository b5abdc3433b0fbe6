"""HF diffusers safetensors -> the SD modules of this package (port of
``superdiff_tpu/models/sd/convert.py``).

An HF snapshot directory (``CompVis/stable-diffusion-v1-4`` layout:
``unet/diffusion_pytorch_model.safetensors``,
``text_encoder/model.safetensors``, ``vae/diffusion_pytorch_model.safetensors``)
loads onto :class:`SDUNet`, :class:`CLIPTextEncoder` and :class:`VAEDecoder`.
Each mapping entry is a (Flax path, HF tensor name, transform) triple, as in
the JAX package: the transform brings the diffusers tensor into the Flax
layout,

  Conv2d  (out, in, kh, kw) -> (kh, kw, in, out)
  Linear  (out, in)         -> (in, out)
  1x1 proj conv             -> Dense (squeeze spatial dims)

and :func:`~superdiff_tpu_torch.models.from_jax.flax_leaf_to_torch` carries
the Flax path and array onto the module's ``state_dict``, since the port's
modules carry the Flax module names.

The safetensors format is read here (:func:`read_safetensors`: an 8-byte
little-endian header length, a JSON header, raw little-endian data; F32 and
F16), so no package beyond numpy is needed. A file that is absent leaves its
module at its random init; a file that is present must convert completely
(:func:`apply_mapping`). The VAE encoder's tensors are left aside, as in the
JAX package: the sampler only decodes.
"""

from __future__ import annotations

import json
import os
import struct
import warnings
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..from_jax import flax_leaf_to_torch, torch_key

_DTYPES = {"F32": "<f4", "F16": "<f2"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file, as read-only numpy views of a
    memory map. Raises ``ValueError`` on a dtype other than F32 and F16."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; "
                             f"the reader takes {sorted(_DTYPES)}")
        start, end = info["data_offsets"]
        out[name] = data[start:end].view(dtype).reshape(info["shape"])
    return out


def _load_safetensors(path: str) -> Optional[Dict[str, np.ndarray]]:
    return read_safetensors(path) if os.path.exists(path) else None


def _conv(w):  # torch conv -> flax conv kernel
    return np.transpose(w, (2, 3, 1, 0))


def _lin(w):  # torch linear -> flax dense kernel
    return np.transpose(w, (1, 0))


def _proj_conv_or_lin(w):
    return _lin(w[:, :, 0, 0]) if w.ndim == 4 else _lin(w)


def _geglu_kernel(w):
    # diffusers packs (value|gate) along the output dim: (2F, C) torch ->
    # (C, 2F) flax -> (C, 2, F) stacked
    k = _lin(w)
    return k.reshape(k.shape[0], 2, k.shape[1] // 2)


def _geglu_bias(b):
    return b.reshape(2, b.shape[0] // 2)


def _resnet_entries(dst: str, src: str):
    return [
        (f"{dst}/norm1/GroupNorm_0/scale", f"{src}.norm1.weight", None),
        (f"{dst}/norm1/GroupNorm_0/bias", f"{src}.norm1.bias", None),
        (f"{dst}/conv1/kernel", f"{src}.conv1.weight", _conv),
        (f"{dst}/conv1/bias", f"{src}.conv1.bias", None),
        (f"{dst}/time_emb_proj/kernel", f"{src}.time_emb_proj.weight", _lin),
        (f"{dst}/time_emb_proj/bias", f"{src}.time_emb_proj.bias", None),
        (f"{dst}/norm2/GroupNorm_0/scale", f"{src}.norm2.weight", None),
        (f"{dst}/norm2/GroupNorm_0/bias", f"{src}.norm2.bias", None),
        (f"{dst}/conv2/kernel", f"{src}.conv2.weight", _conv),
        (f"{dst}/conv2/bias", f"{src}.conv2.bias", None),
        (f"{dst}/conv_shortcut/kernel", f"{src}.conv_shortcut.weight", _conv),
        (f"{dst}/conv_shortcut/bias", f"{src}.conv_shortcut.bias", None),
    ]


def _attn_entries(dst: str, src: str):
    tb = f"{src}.transformer_blocks.0"
    out = [
        (f"{dst}/norm/GroupNorm_0/scale", f"{src}.norm.weight", None),
        (f"{dst}/norm/GroupNorm_0/bias", f"{src}.norm.bias", None),
        (f"{dst}/proj_in/kernel", f"{src}.proj_in.weight", _proj_conv_or_lin),
        (f"{dst}/proj_in/bias", f"{src}.proj_in.bias", None),
        (f"{dst}/proj_out/kernel", f"{src}.proj_out.weight", _proj_conv_or_lin),
        (f"{dst}/proj_out/bias", f"{src}.proj_out.bias", None),
    ]
    blk = f"{dst}/block_0"
    for a in ("attn1", "attn2"):
        out += [
            (f"{blk}/{a}/to_q/kernel", f"{tb}.{a}.to_q.weight", _lin),
            (f"{blk}/{a}/to_k/kernel", f"{tb}.{a}.to_k.weight", _lin),
            (f"{blk}/{a}/to_v/kernel", f"{tb}.{a}.to_v.weight", _lin),
            (f"{blk}/{a}/to_out/kernel", f"{tb}.{a}.to_out.0.weight", _lin),
            (f"{blk}/{a}/to_out/bias", f"{tb}.{a}.to_out.0.bias", None),
        ]
    for i in (1, 2, 3):
        out += [
            (f"{blk}/norm{i}/scale", f"{tb}.norm{i}.weight", None),
            (f"{blk}/norm{i}/bias", f"{tb}.norm{i}.bias", None),
        ]
    out += [
        (f"{blk}/ff_geglu/proj/kernel", f"{tb}.ff.net.0.proj.weight", _geglu_kernel),
        (f"{blk}/ff_geglu/proj/bias", f"{tb}.ff.net.0.proj.bias", _geglu_bias),
        (f"{blk}/ff_out/kernel", f"{tb}.ff.net.2.weight", _lin),
        (f"{blk}/ff_out/bias", f"{tb}.ff.net.2.bias", None),
    ]
    return out


def unet_mapping(n_down: int = 4, layers_per_block: int = 2):
    """(flax path, hf tensor name, transform) triples for the SD UNet."""
    m = [
        ("conv_in/kernel", "conv_in.weight", _conv),
        ("conv_in/bias", "conv_in.bias", None),
        ("time_embed_1/kernel", "time_embedding.linear_1.weight", _lin),
        ("time_embed_1/bias", "time_embedding.linear_1.bias", None),
        ("time_embed_2/kernel", "time_embedding.linear_2.weight", _lin),
        ("time_embed_2/bias", "time_embedding.linear_2.bias", None),
        ("norm_out/GroupNorm_0/scale", "conv_norm_out.weight", None),
        ("norm_out/GroupNorm_0/bias", "conv_norm_out.bias", None),
        ("conv_out/kernel", "conv_out.weight", _conv),
        ("conv_out/bias", "conv_out.bias", None),
    ]
    for i in range(n_down):
        for j in range(layers_per_block):
            m += _resnet_entries(f"down_{i}_res_{j}", f"down_blocks.{i}.resnets.{j}")
            if i != n_down - 1:  # CrossAttn blocks
                m += _attn_entries(f"down_{i}_attn_{j}", f"down_blocks.{i}.attentions.{j}")
        if i != n_down - 1:
            m += [
                (f"down_{i}_downsample/kernel", f"down_blocks.{i}.downsamplers.0.conv.weight", _conv),
                (f"down_{i}_downsample/bias", f"down_blocks.{i}.downsamplers.0.conv.bias", None),
            ]
    m += _resnet_entries("mid_res_0", "mid_block.resnets.0")
    m += _attn_entries("mid_attn", "mid_block.attentions.0")
    m += _resnet_entries("mid_res_1", "mid_block.resnets.1")
    for i in range(n_down):
        for j in range(layers_per_block + 1):
            m += _resnet_entries(f"up_{i}_res_{j}", f"up_blocks.{i}.resnets.{j}")
            if i != 0:  # CrossAttnUpBlocks
                m += _attn_entries(f"up_{i}_attn_{j}", f"up_blocks.{i}.attentions.{j}")
        if i != n_down - 1:
            m += [
                (f"up_{i}_upsample/kernel", f"up_blocks.{i}.upsamplers.0.conv.weight", _conv),
                (f"up_{i}_upsample/bias", f"up_blocks.{i}.upsamplers.0.conv.bias", None),
            ]
    return m


def clip_text_mapping(num_layers: int = 12):
    """(flax path, hf tensor name, transform) for the CLIP text tower."""
    pre = "text_model"
    m = [
        ("token_embedding/embedding", f"{pre}.embeddings.token_embedding.weight", None),
        ("position_embedding", f"{pre}.embeddings.position_embedding.weight", None),
        ("final_layer_norm/scale", f"{pre}.final_layer_norm.weight", None),
        ("final_layer_norm/bias", f"{pre}.final_layer_norm.bias", None),
    ]
    for i in range(num_layers):
        src = f"{pre}.encoder.layers.{i}"
        dst = f"layer_{i}"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            m += [
                (f"{dst}/self_attn/{p}/kernel", f"{src}.self_attn.{p}.weight", _lin),
                (f"{dst}/self_attn/{p}/bias", f"{src}.self_attn.{p}.bias", None),
            ]
        for ln in ("layer_norm1", "layer_norm2"):
            m += [
                (f"{dst}/{ln}/scale", f"{src}.{ln}.weight", None),
                (f"{dst}/{ln}/bias", f"{src}.{ln}.bias", None),
            ]
        m += [
            (f"{dst}/fc1/kernel", f"{src}.mlp.fc1.weight", _lin),
            (f"{dst}/fc1/bias", f"{src}.mlp.fc1.bias", None),
            (f"{dst}/fc2/kernel", f"{src}.mlp.fc2.weight", _lin),
            (f"{dst}/fc2/bias", f"{src}.mlp.fc2.bias", None),
        ]
    return m


def _vae_resnet(dst: str, src: str):
    return [
        (f"{dst}/norm1/GroupNorm_0/scale", f"{src}.norm1.weight", None),
        (f"{dst}/norm1/GroupNorm_0/bias", f"{src}.norm1.bias", None),
        (f"{dst}/conv1/kernel", f"{src}.conv1.weight", _conv),
        (f"{dst}/conv1/bias", f"{src}.conv1.bias", None),
        (f"{dst}/norm2/GroupNorm_0/scale", f"{src}.norm2.weight", None),
        (f"{dst}/norm2/GroupNorm_0/bias", f"{src}.norm2.bias", None),
        (f"{dst}/conv2/kernel", f"{src}.conv2.weight", _conv),
        (f"{dst}/conv2/bias", f"{src}.conv2.bias", None),
        (f"{dst}/shortcut/kernel", f"{src}.conv_shortcut.weight", _conv),
        (f"{dst}/shortcut/bias", f"{src}.conv_shortcut.bias", None),
    ]


def vae_decoder_mapping(n_levels: int = 4, layers_per_block: int = 2):
    """(flax path, hf tensor name, transform) for the VAE decoder path."""
    m = [
        ("post_quant_conv/kernel", "post_quant_conv.weight", _conv),
        ("post_quant_conv/bias", "post_quant_conv.bias", None),
        ("conv_in/kernel", "decoder.conv_in.weight", _conv),
        ("conv_in/bias", "decoder.conv_in.bias", None),
        ("norm_out/GroupNorm_0/scale", "decoder.conv_norm_out.weight", None),
        ("norm_out/GroupNorm_0/bias", "decoder.conv_norm_out.bias", None),
        ("conv_out/kernel", "decoder.conv_out.weight", _conv),
        ("conv_out/bias", "decoder.conv_out.bias", None),
    ]
    m += _vae_resnet("mid_res_0", "decoder.mid_block.resnets.0")
    m += _vae_resnet("mid_res_1", "decoder.mid_block.resnets.1")
    att = "decoder.mid_block.attentions.0"
    m += [
        ("mid_attn/norm/GroupNorm_0/scale", f"{att}.group_norm.weight", None),
        ("mid_attn/norm/GroupNorm_0/bias", f"{att}.group_norm.bias", None),
        ("mid_attn/q/kernel", f"{att}.to_q.weight", _proj_conv_or_lin),
        ("mid_attn/q/bias", f"{att}.to_q.bias", None),
        ("mid_attn/k/kernel", f"{att}.to_k.weight", _proj_conv_or_lin),
        ("mid_attn/k/bias", f"{att}.to_k.bias", None),
        ("mid_attn/v/kernel", f"{att}.to_v.weight", _proj_conv_or_lin),
        ("mid_attn/v/bias", f"{att}.to_v.bias", None),
        ("mid_attn/proj_out/kernel", f"{att}.to_out.0.weight", _proj_conv_or_lin),
        ("mid_attn/proj_out/bias", f"{att}.to_out.0.bias", None),
    ]
    for i in range(n_levels):
        for j in range(layers_per_block + 1):
            m += _vae_resnet(f"up_{i}_res_{j}", f"decoder.up_blocks.{i}.resnets.{j}")
        if i != n_levels - 1:
            m += [
                (f"up_{i}_conv/kernel", f"decoder.up_blocks.{i}.upsamplers.0.conv.weight", _conv),
                (f"up_{i}_conv/bias", f"decoder.up_blocks.{i}.upsamplers.0.conv.bias", None),
            ]
    return m


def _is_optional(src: str) -> bool:
    """Diffusers checkpoints carry resnet ``conv_shortcut`` tensors only on
    width-changing resnets; every other mapped tensor is required."""
    return ".conv_shortcut." in src


def apply_mapping(state: Dict[str, torch.Tensor], tensors: Dict[str, np.ndarray], mapping,
                  unused_prefixes=(), unused_suffixes=()):
    """Write the mapped tensors into ``state`` (a module's ``state_dict``,
    updated in place and returned; each tensor keeps its dtype). Strict, as
    the JAX package's:

    * raises ``KeyError`` when a required mapped tensor is absent from the
      checkpoint (renamed keys must fail loudly, not sample garbage);
    * optional entries (resnet ``conv_shortcut``) must be present in the
      checkpoint exactly when the module has them; one-sided presence
      raises;
    * warns on leftover checkpoint tensors not covered by the mapping or the
      ``unused_*`` filters."""
    missing = []
    for dst, src, tf in mapping:
        have_ckpt = src in tensors
        if _is_optional(src):
            have_module = torch_key(dst) in state
            if have_ckpt != have_module:
                raise KeyError(
                    f"optional tensor mismatch for {src!r}: present in checkpoint="
                    f"{have_ckpt}, module exists={have_module}: the model config does "
                    "not match the checkpoint topology")
            if not have_ckpt:
                continue
        elif not have_ckpt:
            missing.append(src)
            continue
        val = np.asarray(tensors[src], dtype=np.float32)
        key, value = flax_leaf_to_torch(dst, tf(val) if tf else val)
        old = state[key]
        if old.shape != value.shape:
            raise ValueError(f"{src} -> {key}: {tuple(value.shape)} vs {tuple(old.shape)}")
        state[key] = value.to(old.dtype)
    if missing:
        raise KeyError(f"checkpoint is missing {len(missing)} required tensors, e.g. "
                       f"{missing[:5]}")
    covered = {src for _, src, _ in mapping}
    leftover = sorted(
        k for k in tensors
        if k not in covered
        and not (unused_prefixes and k.startswith(tuple(unused_prefixes)))
        and not (unused_suffixes and k.endswith(tuple(unused_suffixes))))
    if leftover:
        warnings.warn(f"{len(leftover)} unconverted checkpoint tensors: {leftover[:8]}",
                      stacklevel=2)
    return state


def _load_into(module: nn.Module, path: str, mapping, **filters) -> None:
    tensors = _load_safetensors(path)
    if tensors:
        module.load_state_dict(apply_mapping(module.state_dict(), tensors, mapping, **filters))


def load_sd_weights(weights_dir: str, unet: nn.Module, text: nn.Module, vae: nn.Module, *,
                    clip_num_layers: int = 12, unet_n_down: int = 4,
                    unet_layers_per_block: int = 2, vae_n_levels: int = 4,
                    vae_layers_per_block: int = 2) -> None:
    """Load an HF snapshot directory into the UNet, the text encoder and the
    VAE decoder in place. Each sub-conversion is strict
    (:func:`apply_mapping`), so a return means every mapped tensor landed."""
    _load_into(unet, os.path.join(weights_dir, "unet", "diffusion_pytorch_model.safetensors"),
               unet_mapping(n_down=unet_n_down, layers_per_block=unet_layers_per_block))
    _load_into(text, os.path.join(weights_dir, "text_encoder", "model.safetensors"),
               clip_text_mapping(num_layers=clip_num_layers),
               # transformers' registered buffer; also the projection head of
               # CLIPModel-format dumps: neither feeds the text tower forward
               unused_suffixes=(".position_ids",), unused_prefixes=("text_projection",))
    _load_into(vae, os.path.join(weights_dir, "vae", "diffusion_pytorch_model.safetensors"),
               vae_decoder_mapping(n_levels=vae_n_levels, layers_per_block=vae_layers_per_block),
               # decode-only path: the encoder tower and quant_conv are unused
               unused_prefixes=("encoder.", "quant_conv."))
