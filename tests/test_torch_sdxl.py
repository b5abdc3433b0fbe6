"""SDXL in the port against the benchmark's plain SDXL reference
(``benchmark/reference/sdxl-base-1.0.py``), fp32 on the CPU at a tiny cut
of the published configuration: three levels (no attention at the first),
transformer depth (1, 1, 2), head dim 16, both towers (the second with its
``text_projection``, exact gelu, padding with id 0), the ``text_time``
added embedding and zeros for the empty prompt. Both sides load one drawn
state dict (the benchmark's draw, float32).

Tolerances: 1e-4 of the compared output's largest magnitude for one UNet
forward and for the towers (fp32 on both sides; the port's LayerNorm and
GroupNorm take their statistics in other orders than ``F.layer_norm`` /
``F.group_norm``, its attention sums in another order); the 4-step ``or``
trajectory 1e-4 of the distance the networks moved the latents and of the
log-likelihoods' distance from their start, as the benchmark's check
compares them (rounding compounds over the steps).

Also: SD-1.x's UNet builds the same state-dict keys and shapes as before
SDXL came (a digest of the list), SDXL's published UNet its 2.567 B
parameters, and the dedup's row checks raise.
"""

import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import weights
from superdiff_tpu_torch.models.sd.clip import CLIPTextConfig, CLIPTextEncoder, Tokenizer
from superdiff_tpu_torch.models.sd.unet import (
    ResnetBlock2D,
    SDUNet,
    SDUNetConfig,
    TransformerBlock,
)
from superdiff_tpu_torch.models.sd.vae import VAEConfig, VAEDecoder
from superdiff_tpu_torch.pipelines import sd

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 5
B = 2  # latent rows; three conditionings


def _reference():
    path = os.path.join(ROOT, "benchmark", "reference", "sdxl-base-1.0.py")
    spec = importlib.util.spec_from_file_location("benchmark.reference.sdxl_base_1_0", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def tiny_config() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", "sdxl-base-1.0.json")) as fh:
        c = json.load(fh)
    c["unet"].update(block_out_channels=[32, 64, 64], attention_head_dim=[2, 4, 4],
                     transformer_layers_per_block=[1, 1, 2], cross_attention_dim=64,
                     addition_time_embed_dim=8, projection_class_embeddings_input_dim=32 + 6 * 8)
    for key in ("text_encoder", "text_encoder_2"):
        c[key].update(vocab_size=1000, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, projection_dim=32)
    c["vae"].update(block_out_channels=[32, 64], layers_per_block=1)
    c["method"].update(num_inference_steps=4, size_ids=[64, 64, 0, 0, 64, 64])
    return c


def port_configs(c: dict):
    u = c["unet"]
    ucfg = SDUNetConfig(
        block_out_channels=tuple(u["block_out_channels"]), layers_per_block=u["layers_per_block"],
        cross_attention_dim=u["cross_attention_dim"],
        attention_head_dim=tuple(u["attention_head_dim"]),
        transformer_layers_per_block=tuple(u["transformer_layers_per_block"]),
        down_block_types=tuple(u["down_block_types"]), up_block_types=tuple(u["up_block_types"]),
        addition_embed_type=u["addition_embed_type"],
        addition_time_embed_dim=u["addition_time_embed_dim"],
        projection_class_embeddings_input_dim=u["projection_class_embeddings_input_dim"])

    def text(t, projected):
        return CLIPTextConfig(vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                              num_layers=t["num_hidden_layers"],
                              num_heads=t["num_attention_heads"], hidden_act=t["hidden_act"],
                              projection_dim=t["projection_dim"] if projected else 0,
                              output="penultimate")

    return ucfg, text(c["text_encoder"], False), text(c["text_encoder_2"], True)


@pytest.fixture(scope="module")
def stacks():
    """(config, the reference's modules, the port's SDModules), one draw."""
    c = tiny_config()
    state = weights.draw(REF.build(c, "meta"), lambda *_: torch.float32, SEED, "cpu")
    ref = REF.build(c)
    for part, m in ref.items():
        m.load_state_dict(state[part], strict=True)
        m.eval().requires_grad_(False)
    ucfg, tl, tg = port_configs(c)
    v = c["vae"]
    vcfg = VAEConfig(base_channels=32, channel_mults=(1, 2), layers_per_block=1,
                     scaling_factor=v["scaling_factor"])
    f32 = torch.float32
    parts = {"unet": SDUNet(ucfg, dtype=f32), "text": CLIPTextEncoder(tl, dtype=f32),
             "text_2": CLIPTextEncoder(tg, dtype=f32), "vae": VAEDecoder(vcfg, dtype=f32)}
    for part, m in parts.items():
        m.load_state_dict(state[part], strict=True)
        m.eval().requires_grad_(False)
    mod = sd.SDModules(unet=parts["unet"], text=parts["text"], tokenizer=Tokenizer(tl),
                       vae=parts["vae"], vae_scaling=v["scaling_factor"],
                       device=torch.device("cpu"), text_2=parts["text_2"],
                       tokenizer_2=Tokenizer(tg, pad_id=0),
                       force_zeros_for_empty_prompt=c["force_zeros_for_empty_prompt"])
    return c, ref, mod


def _inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, 32, 32, 4, generator=g)  # 32 x 32: 256 tokens at level 1
    ctx = torch.randn(3 * B, 77, 64, generator=g)
    pooled = torch.randn(3 * B, 32, generator=g)
    return x, ctx, pooled


def _close(got, want, tol):
    scale = want.abs().max()
    err = (got - want).abs().max()
    assert err <= tol * scale, (err.item(), scale.item())


@pytest.mark.parametrize("dedup", [True, False])
def test_unet_matches_reference(stacks, dedup):
    c, ref, mod = stacks
    x, ctx, pooled = _inputs()
    ids = torch.tensor(c["method"]["size_ids"], dtype=torch.float32)
    want = ref["unet"](x.repeat(3, 1, 1, 1), torch.tensor(481.0), ctx, pooled, ids)
    with torch.no_grad():
        got = mod.unet(x if dedup else x.repeat(3, 1, 1, 1), torch.tensor(481.0), ctx,
                       text_embeds=pooled, time_ids=ids)
    assert got.shape == want.shape == (3 * B, 32, 32, 4)
    _close(got, want, 1e-4)


def test_dedup_keeps_each_conditionings_pooled_embedding(stacks):
    """The pooled embedding enters every resnet's time embedding: changing
    one conditioning's moves that conditioning's output in the reference
    (no rows shared), and the port's dedup forward (latents entering once)
    follows it there and nowhere else."""
    c, ref, mod = stacks
    x, ctx, pooled = _inputs(2)
    ids = torch.tensor(c["method"]["size_ids"], dtype=torch.float32)
    other = pooled.clone()
    other[B:2 * B] = torch.randn(B, 32, generator=torch.Generator().manual_seed(9))
    want = ref["unet"](x.repeat(3, 1, 1, 1), torch.tensor(300.0), ctx, pooled, ids)
    want2 = ref["unet"](x.repeat(3, 1, 1, 1), torch.tensor(300.0), ctx, other, ids)
    moved = (want2 - want).abs().amax(dim=(1, 2, 3))
    assert (moved[B:2 * B] > 1e-2 * want.abs().max()).all(), moved
    assert (moved[:B] == 0).all() and (moved[2 * B:] == 0).all(), moved
    with torch.no_grad():
        got = mod.unet(x, torch.tensor(300.0), ctx, text_embeds=other, time_ids=ids)
    _close(got, want2, 1e-4)


@pytest.mark.parametrize("part", ["text", "text_2"])
def test_tower_matches_reference(stacks, part):
    c, ref, mod = stacks
    key = {"text": "text_encoder", "text_2": "text_encoder_2"}[part]
    t = c[key]
    prompts = ["a cat", "a lighthouse by the sea", ""]
    pad = REF.eos_id(t["vocab_size"]) if part == "text" else 0
    ids = torch.as_tensor(REF.tokenize(prompts, t["vocab_size"], 77, pad))
    tok = mod.tokenizer if part == "text" else mod.tokenizer_2
    assert np.array_equal(tok(prompts), ids.numpy())
    want_h, want_p = ref[part](ids)
    with torch.no_grad():
        got_h, got_p = getattr(mod, part)(ids)
    _close(got_h, want_h, 1e-4)
    if part == "text":
        assert got_p is None and want_p is None
    else:
        assert got_p.shape == (3, 32)
        _close(got_p, want_p, 1e-4)


def test_or_trajectory_matches_reference(stacks):
    """Four ``or`` steps through ``generate`` (encoding, the sampler with
    dedup, the decode) against the reference's sampler on the same
    normals: latents, kappa and the log-likelihood traces."""
    c, ref, mod = stacks
    m = c["method"]
    g = torch.Generator().manual_seed(3)
    x_T = torch.randn(B, 8, 8, 4, generator=g)
    zs = torch.randn(4, B, 8, 8, 4, generator=g)
    cfg = sd.SDPipelineConfig(num_inference_steps=4, guidance_scale=m["guidance_scale"],
                              height=64, width=64)
    out = sd.generate(mod, "or", "a teapot", "an elephant", batch_size=B, cfg=cfg,
                      noise=(x_T, zs), capture=False)
    lat, kappa, ll, _ = REF.sample_or(ref, c, "a teapot", "an elephant", x_T, zs, m)
    moved = (lat - REF.noise_path(x_T, zs)).abs().max()
    assert (out["latents"] - lat).abs().max() <= 1e-4 * moved
    got_ll = torch.stack([out["traces"]["ll_obj"], out["traces"]["ll_bg"]], -1)
    assert (got_ll - ll).abs().max() <= 1e-4 * (ll - 1.0).abs().max()
    assert (out["traces"]["kappa"] - kappa).abs().max() <= 1e-4
    img = REF.decode(ref["vae"], out["latents"], c["vae"]["scaling_factor"])
    assert (out["images"].float() - img).abs().max() <= 1.0


def test_sdxl_needs_its_added_conditioning(stacks):
    _, _, mod = stacks
    x, ctx, pooled = _inputs()
    with pytest.raises(ValueError, match="added embedding"):
        mod.unet(x, 1.0, ctx)
    with pytest.raises(ValueError, match="added embedding"):
        sd.SDUNet(SDUNetConfig.tiny(), dtype=torch.float32)(
            torch.zeros(1, 16, 16, 4), 1.0, torch.zeros(3, 77, 64), text_embeds=pooled,
            time_ids=torch.zeros(6))


def test_dedup_row_counts_that_do_not_divide_raise():
    res = ResnetBlock2D(32, 32, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="2 rows of the activations against 4 of the time"):
        res(torch.zeros(2, 32, 4, 4), torch.zeros(4, 64))
    blk = TransformerBlock(32, 2, 16, dtype=torch.float32, attn_impl="einsum",
                           ffn_impl="einsum")
    with pytest.raises(ValueError, match="3 rows of the context against 2 of the activations"):
        blk(torch.zeros(2, 16, 32), torch.zeros(3, 77, 16))


# SD-1.4's UNet state dict (key, shape) list as it stood before SDXL came:
# 686 entries, 859 520 964 parameters
SD14_DIGEST = "aa525da87b2b7d8d1246df35884896cf"


def test_sd14_unet_state_dict_is_unchanged():
    with torch.device("meta"):
        net = SDUNet(SDUNetConfig())
    entries = [(k, tuple(v.shape)) for k, v in net.state_dict().items()]
    assert len(entries) == 686
    assert sum(p.numel() for p in net.parameters()) == 859_520_964
    assert hashlib.md5(str(entries).encode()).hexdigest() == SD14_DIGEST


def test_sdxl_base_unet_on_meta():
    """The published SDXL UNet: 2 567 463 684 parameters, 70 transformer
    blocks, head dim 64 at every attention."""
    with torch.device("meta"):
        net = SDUNet(SDUNetConfig.sdxl_base())
    assert sum(p.numel() for p in net.parameters()) == 2_567_463_684
    blocks = [m for m in net.modules() if isinstance(m, TransformerBlock)]
    assert len(blocks) == 70
    assert {b.attn1.to_q.weight.shape[0] // b.attn1.heads for b in blocks} == {64}
    assert not any(n.startswith("down_0_attn") or n.startswith("up_2_attn")
                   for n, _ in net.named_children())
