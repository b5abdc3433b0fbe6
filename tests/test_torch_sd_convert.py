"""The port's HF diffusers safetensors loader (``models/sd/convert.py``) vs the
JAX package's, on a synthetic tiny snapshot (no real weights exist here): the
same files loaded by the JAX package (``convert.load_sd_weights`` with the
arguments its ``build_sd_modules(weights_dir=)`` passes, onto zero-filled
trees of its init's shapes: the jitted inits alone would take most of a
minute) and by the port's ``build_sd_modules(weights_dir=, device="cpu")``
give the same UNet, CLIP and VAE-decoder outputs in fp32 (1e-5 of the
largest output, as the other parity tests); the port's own safetensors
reader equals ``safetensors.numpy.load_file``; the loader is as strict as
JAX's.

The snapshot is built from drawn Flax trees, each tensor put into the
diffusers layout by the inverse of its mapping transform (the JAX package's
mapping, so the port's copy of it is held against it).
"""

import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file
from torch_parity import draw_params, t

from superdiff_tpu.models.sd import clip as jclip
from superdiff_tpu.models.sd import convert as jconvert
from superdiff_tpu.models.sd import unet as junet
from superdiff_tpu.models.sd import vae as jvae
from superdiff_tpu.pipelines import sd as jsd
from superdiff_tpu_torch.models.sd import convert
from superdiff_tpu_torch.models.sd.clip import CLIPTextConfig
from superdiff_tpu_torch.models.sd.unet import SDUNetConfig
from superdiff_tpu_torch.models.sd.vae import VAEConfig
from superdiff_tpu_torch.pipelines import sd

torch.set_num_threads(1)

# the inverse of each mapping transform: Flax layout -> diffusers layout
_TO_HF = {
    jconvert._conv: lambda a: np.transpose(a, (3, 2, 0, 1)),
    jconvert._lin: lambda a: a.T,
    jconvert._proj_conv_or_lin: lambda a: a.T,
    jconvert._geglu_kernel: lambda a: a.reshape(a.shape[0], -1).T,
    jconvert._geglu_bias: lambda a: a.reshape(-1),
    None: lambda a: a,
}


def _leaf(tree, path):
    for k in path.split("/"):
        if k not in tree:
            return None
        tree = tree[k]
    return np.asarray(tree)


def _hf_tensors(params, mapping):
    return {src: np.ascontiguousarray(_TO_HF[tf](a), dtype=np.float32)
            for dst, src, tf in mapping if (a := _leaf(params, dst)) is not None}


def _cfgs():
    ucfg = dataclasses.replace(junet.SDUNetConfig.tiny(), attn_impl="einsum", ffn_impl="einsum")
    return ucfg, jclip.CLIPTextConfig.tiny(), jvae.VAEConfig.tiny()


def _jax_modules():
    ucfg, tcfg, vcfg = _cfgs()
    f32 = jnp.float32
    return (junet.SDUNet(ucfg, dtype=f32), jclip.CLIPTextEncoder(tcfg, dtype=f32),
            jvae.VAEDecoder(vcfg, dtype=f32))


@pytest.fixture(scope="module")
def trees():
    """Drawn Flax trees for the three JAX modules."""
    unet, text, vae = _jax_modules()
    return (draw_params(unet, jnp.zeros((1, 16, 16, 4)), jnp.zeros(()), jnp.zeros((1, 77, 64)),
                        seed=21),
            draw_params(text, jnp.zeros((1, 77), jnp.int32), seed=22),
            draw_params(vae, jnp.zeros((1, 8, 8, 4)), seed=23))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory, trees):
    """A tiny HF snapshot directory with the three model files."""
    root = tmp_path_factory.mktemp("snapshot")
    _, tcfg, vcfg = _cfgs()
    up, tp, vp = trees
    unet_t = _hf_tensors(up, jconvert.unet_mapping())
    text_t = _hf_tensors(tp, jconvert.clip_text_mapping(num_layers=tcfg.num_layers))
    # transformers dumps carry this buffer; both loaders leave it aside
    text_t["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.float32)[None]
    vae_t = _hf_tensors(vp, jconvert.vae_decoder_mapping(
        n_levels=len(vcfg.channel_mults), layers_per_block=vcfg.layers_per_block))
    # the encoder tower is in the file but converted by neither package
    vae_t["encoder.conv_in.weight"] = np.zeros((32, 3, 3, 3), np.float32)
    vae_t["quant_conv.weight"] = np.zeros((8, 8, 1, 1), np.float32)
    for sub, name, tensors in (("unet", "diffusion_pytorch_model", unet_t),
                               ("text_encoder", "model", text_t),
                               ("vae", "diffusion_pytorch_model", vae_t)):
        (root / sub).mkdir()
        save_file(tensors, str(root / sub / f"{name}.safetensors"))
    return root


def _port_build(weights_dir):
    return sd.build_sd_modules(
        5, unet_config=dataclasses.replace(SDUNetConfig.tiny(), attn_impl="einsum"),
        text_config=CLIPTextConfig.tiny(), vae_config=VAEConfig.tiny(),
        weights_dir=weights_dir, device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def loaded(snapshot, trees):
    """(JAX modules, port modules), both loaded from ``snapshot``."""
    ucfg, tcfg, vcfg = _cfgs()
    unet, text, vae = _jax_modules()
    zeros = [jax.tree.map(np.zeros_like, tr) for tr in trees]
    up, tp, vp = jconvert.load_sd_weights(
        str(snapshot), *zeros, clip_num_layers=tcfg.num_layers,
        unet_n_down=len(ucfg.block_out_channels), unet_layers_per_block=ucfg.layers_per_block,
        vae_n_levels=len(vcfg.channel_mults), vae_layers_per_block=vcfg.layers_per_block)
    jmod = jsd.SDModules(unet=unet, unet_params=up, text=text, text_params=tp,
                         tokenizer=jclip.Tokenizer(tcfg), vae=vae, vae_params=vp,
                         vae_scaling=vcfg.scaling_factor)
    return jmod, _port_build(str(snapshot))


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale, rtol=0, atol=tol)


def test_loaded_unet_matches_jax(loaded):
    jmod, mod = loaded
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((3, 77, 64)).astype(np.float32)
    # compiled: the eager forward's many first-time dispatches take longer
    ref = jax.jit(jmod.unet.apply)({"params": jmod.unet_params}, x, np.float32(311.0), ctx)
    with torch.no_grad():
        got = mod.unet(t(x), torch.tensor(311.0), t(ctx))
    _close(got.numpy(), ref)


def test_loaded_text_encoder_matches_jax(loaded):
    jmod, mod = loaded
    ids = jmod.tokenizer(["a cat on a mat", ""])
    ref = jmod.text.apply({"params": jmod.text_params}, jnp.asarray(ids))
    with torch.no_grad():
        got = mod.text(t(ids).long())
    _close(got.numpy(), ref)


def test_loaded_vae_decoder_matches_jax(loaded):
    jmod, mod = loaded
    z = np.random.default_rng(2).standard_normal((1, 8, 8, 4)).astype(np.float32)
    ref = jmod.vae.apply({"params": jmod.vae_params}, jnp.asarray(z))
    with torch.no_grad():
        got = mod.vae(t(z))
    _close(got.numpy(), ref)


def test_weights_land_and_absent_files_keep_the_random_init(snapshot, tmp_path):
    mod = _port_build(str(snapshot))
    rand = _port_build(None)
    # the first UNet conv is the checkpoint's, not the seed's
    want = load_file(str(snapshot / "unet" / "diffusion_pytorch_model.safetensors"))[
        "conv_in.weight"]  # OIHW in both
    np.testing.assert_array_equal(mod.unet.conv_in.weight.numpy(), want)
    assert not torch.equal(mod.unet.conv_in.weight, rand.unet.conv_in.weight)
    # only the UNet file present: text encoder and VAE keep their random init
    (tmp_path / "unet").mkdir()
    (tmp_path / "unet" / "diffusion_pytorch_model.safetensors").symlink_to(
        snapshot / "unet" / "diffusion_pytorch_model.safetensors")
    part = _port_build(str(tmp_path))
    for a, b in ((part.text, rand.text), (part.vae, rand.vae)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    assert torch.equal(part.unet.conv_in.weight, mod.unet.conv_in.weight)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_reader_matches_safetensors(tmp_path, dtype):
    rng = np.random.default_rng(3)
    tensors = {"a.weight": rng.standard_normal((3, 5, 2, 2)).astype(dtype),
               "b": rng.standard_normal((7,)).astype(dtype),
               "scalar": np.array(2.5, dtype=dtype),
               "empty": np.zeros((0, 4), dtype=dtype)}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    ref, got = load_file(path), convert.read_safetensors(path)
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name].dtype == ref[name].dtype and got[name].shape == ref[name].shape
        np.testing.assert_array_equal(got[name], ref[name])


@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_reader_refuses_other_dtypes(tmp_path, dtype):
    path = str(tmp_path / "x.safetensors")
    save_file({"ok": np.ones(3, np.float32), "bad": np.ones(3, dtype)}, path)
    with pytest.raises(ValueError, match="dtype"):
        convert.read_safetensors(path)


def test_reader_takes_the_header_as_written(tmp_path):
    """Format by hand: 8-byte little-endian header length, JSON header with
    byte offsets into the data that follows."""
    a = np.arange(6, dtype="<f4").reshape(2, 3)
    header = json.dumps({"a": {"dtype": "F32", "shape": [2, 3],
                               "data_offsets": [0, a.nbytes]}}).encode()
    path = tmp_path / "hand.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + a.tobytes())
    np.testing.assert_array_equal(convert.read_safetensors(str(path))["a"], a)


def _unet_state_and_tensors(snapshot):
    mod = _port_build(None)
    tensors = dict(convert.read_safetensors(
        str(snapshot / "unet" / "diffusion_pytorch_model.safetensors")))
    return mod.unet.state_dict(), tensors, convert.unet_mapping()


def test_missing_required_tensor_raises(snapshot):
    state, tensors, mapping = _unet_state_and_tensors(snapshot)
    # a key renamed, as a diffusers version bump might
    tensors["mid_block.resnets.0.conv_1.weight"] = tensors.pop("mid_block.resnets.0.conv1.weight")
    with pytest.raises(KeyError, match="missing 1 required"):
        convert.apply_mapping(state, tensors, mapping)


def test_optional_tensor_mismatch_raises(snapshot):
    state, tensors, mapping = _unet_state_and_tensors(snapshot)
    assert "down_blocks.3.resnets.1.conv_shortcut.weight" not in tensors
    tensors["down_blocks.3.resnets.1.conv_shortcut.weight"] = np.zeros((64, 64, 1, 1), np.float32)
    with pytest.raises(KeyError, match="optional tensor mismatch"):
        convert.apply_mapping(state, tensors, mapping)


def test_leftover_tensors_warn(snapshot):
    state, tensors, mapping = _unet_state_and_tensors(snapshot)
    tensors["some.unknown.buffer"] = np.zeros((3,), np.float32)
    with pytest.warns(UserWarning, match="unconverted"):
        convert.apply_mapping(state, tensors, mapping)


def test_mappings_equal_the_jax_package():
    def names(m):
        return [(dst, src, getattr(tf, "__name__", None)) for dst, src, tf in m]

    assert names(convert.unet_mapping()) == names(jconvert.unet_mapping())
    assert names(convert.clip_text_mapping(3)) == names(jconvert.clip_text_mapping(3))
    assert names(convert.vae_decoder_mapping(2, 1)) == names(jconvert.vae_decoder_mapping(2, 1))
