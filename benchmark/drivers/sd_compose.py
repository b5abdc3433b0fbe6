"""Traffic of Stable-Diffusion prompt composition: requests of one prompt
pair each, drawn from the mix's list, served back to back by
``superdiff_tpu_torch.pipelines.sd.generate`` (text encoding, the
composition sampler, the VAE decode to uint8) on the program's modules,
with the weights and the noise the benchmark draws from the seed.

Spans: ``inputs`` (the request's noise), ``encode`` (each call of the text
encoder), ``sample`` (from the end of the last encoding, or of the inputs
where the request encodes nothing, to the decoder's start: the step loop;
the token ids' copies of any later encoding, a few KB, fall in it too),
``decode``; forward hooks on the text encoder and the decoder mark the
turns, with no edit to the program and whatever number of encoder calls it
makes. The sampler's device time is taken between CUDA events recorded in
the same hooks.

The check runs the configuration's plain reference over a sample of the
window's requests and of their rows, drawn from the seed, and compares the
latents, the log-likelihood traces (which set kappa) and the uint8 images.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.driver import Driver as Base
from benchmark.harness.weights import generator, subseed
from benchmark.harness.yardstick import attention_work, count_flops, geglu_ffn_work
from benchmark.reference._precision import precision


class Driver(Base):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        c, t = cell.config, cell.traffic
        self.batch, self.h, self.w = t["batch"], t["height"] // 8, t["width"] // 8
        self.steps = c["method"]["num_inference_steps"]
        self.samples_per_request = self.batch

    # ------------------------------------------------------------ program
    def build(self, state):
        from superdiff_tpu_torch.models.sd.clip import CLIPTextConfig, CLIPTextEncoder, Tokenizer
        from superdiff_tpu_torch.models.sd.unet import SDUNet, SDUNetConfig
        from superdiff_tpu_torch.models.sd.vae import VAEConfig, VAEDecoder
        from superdiff_tpu_torch.pipelines.sd import SDModules, SDPipelineConfig

        c, t = self.cell.config, self.cell.traffic
        u, tx, v, m = c["unet"], c["text_encoder"], c["vae"], c["method"]
        dtype = getattr(torch, c["dtype"])
        ucfg = SDUNetConfig(
            in_channels=u["in_channels"], out_channels=u["out_channels"],
            block_out_channels=tuple(u["block_out_channels"]),
            layers_per_block=u["layers_per_block"], cross_attention_dim=u["cross_attention_dim"],
            attention_head_dim=u["attention_head_dim"],
            down_block_types=tuple(u["down_block_types"]), up_block_types=tuple(u["up_block_types"]))
        tcfg = CLIPTextConfig(vocab_size=tx["vocab_size"], hidden_size=tx["hidden_size"],
                              num_layers=tx["num_hidden_layers"],
                              num_heads=tx["num_attention_heads"],
                              max_length=tx["max_position_embeddings"])
        base = v["block_out_channels"][0]
        vcfg = VAEConfig(latent_channels=v["latent_channels"], base_channels=base,
                         channel_mults=tuple(ch // base for ch in v["block_out_channels"]),
                         layers_per_block=v["layers_per_block"], scaling_factor=v["scaling_factor"])
        with torch.device(self.device):
            parts = {"unet": SDUNet(ucfg, dtype=dtype), "text": CLIPTextEncoder(tcfg, dtype=dtype),
                     "vae": VAEDecoder(vcfg, out_channels=v["out_channels"], dtype=dtype)}
        for name, mod in parts.items():
            mod.load_state_dict(state[name], strict=True)
            mod.eval().requires_grad_(False)
        self.mod = SDModules(unet=parts["unet"], text=parts["text"], tokenizer=Tokenizer(tcfg),
                             vae=parts["vae"], vae_scaling=v["scaling_factor"],
                             device=torch.device(self.device))
        self.pcfg = SDPipelineConfig(
            num_inference_steps=self.steps, guidance_scale=m["guidance_scale"],
            height=t["height"], width=t["width"], temperature=m["temperature"], logp=m["logp"])
        parts["text"].register_forward_pre_hook(self._before_encode)
        parts["text"].register_forward_hook(self._after_encode)
        parts["vae"].register_forward_pre_hook(self._before_decode)

    def _before_encode(self, *_):
        self.phases.to("encode")

    def _after_encode(self, *_):
        self.span_begin("sample")  # again after each encoding: the last one's end stays

    def _before_decode(self, *_):
        self.span_end("decode")

    def inputs(self, i: int, rows=None):
        """Request ``i``'s prompt pair and unit normals (x_T, zs), its
        ``rows`` only where given."""
        pairs = self.cell.traffic["prompts"]
        obj, bg = pairs[int(np.random.default_rng(subseed(self.seed, 1, i)).integers(len(pairs)))]
        g = generator(self.device, self.seed, 2, i)
        x_T = torch.randn((self.batch, self.h, self.w, 4), generator=g, device=self.device)
        zs = torch.randn((self.steps, self.batch, self.h, self.w, 4), generator=g,
                         device=self.device)
        if rows is not None:
            x_T, zs = x_T[rows], zs[:, rows]
        return obj, bg, x_T, zs

    def serve(self, i: int):
        from superdiff_tpu_torch.pipelines.sd import generate

        self.phases.to("inputs")
        obj, bg, x_T, zs = self.inputs(i)
        self.span_begin("encode")
        out = generate(self.mod, self.cell.traffic["method"], obj, bg, batch_size=self.batch,
                       cfg=self.pcfg, noise=(x_T, zs))
        tr = out["traces"]
        return {"latents": out["latents"], "ll": torch.stack([tr["ll_obj"], tr["ll_bg"]], -1),
                "images": out["images"]}

    def release(self):
        self.mod = None
        super().release()

    # ---------------------------------------------------------- reference
    def reference_answers(self, ref, models, i: int, rows, mode: str):
        """The reference's answers to request ``i`` on ``rows``, computed in
        ``mode``, in the program's layout."""
        c = self.cell.config
        obj, bg, x_T, zs = self.inputs(i, rows)
        with precision(mode):
            lat, _, ll, margin = ref.sample_or(models, c, obj, bg, x_T, zs, c["method"])
            img = ref.decode(models["vae"], lat, c["vae"]["scaling_factor"])
        return {"latents": lat, "ll": ll, "images": img.to(torch.uint8), "margin": margin}

    def row_numbers(self, ref, models, i: int, rows, answers, truth):
        """Per row: the latents' distance from the reference's over the
        distance the networks moved them and the log-likelihood traces' over
        theirs, on the rows whose kappa the reference sets by more than
        ``check.or_margin`` (a tie within rounding turns the trajectory);
        the images' mean distance in levels from the reference's decode of
        the same latents, on every row."""
        c = self.cell.config
        _, _, x_T, zs = self.inputs(i, rows)
        lat = answers["latents"].float()
        with precision("fp32"):
            img_ref = ref.decode(models["vae"], lat, c["vae"]["scaling_factor"])
        moved = truth["latents"] - ref.noise_path(x_T, zs)
        ll_p, ll_r = (a.transpose(0, 1).reshape(len(rows), -1) for a in (answers["ll"],
                                                                          truth["ll"]))
        img_gap = (answers["images"].float() - img_ref).abs().reshape(len(rows), -1).mean(1)
        kept = truth["margin"] >= self.cell.traffic["check"]["or_margin"]
        self.notes.append(f"request {i}: {int((~kept).sum())} of {len(rows)} rows' latents and "
                          "traces left out, their kappa a tie within rounding in the reference")
        return {
            "latents": compare.row_gap(lat, truth["latents"], moved)[kept],
            "ll": compare.row_gap(ll_p, ll_r, ll_r - 1.0)[kept],
            "images": img_gap.double(),
        }

    @staticmethod
    def pick(answers: dict, rows) -> dict:
        """Request answers restricted to ``rows`` (traces are step-major)."""
        return {"latents": answers["latents"][rows], "ll": answers["ll"][:, rows],
                "images": answers["images"][rows]}

    # ---------------------------------------------------------- yardstick
    def model_flops(self, ref) -> int:
        """FLOPs of one request as the plain reference counts them: three
        prompt encodings, the UNet forward (conditioning shared) a step,
        the decode."""
        c, b = self.cell.config, self.batch
        m = ref.build(c, "meta")
        lat = torch.empty((b, self.h, self.w, 4), device="meta")
        ctx = torch.empty((3 * b, c["text_encoder"]["max_position_embeddings"],
                           c["text_encoder"]["hidden_size"]), device="meta")
        ids = torch.zeros(ctx.shape[:2], dtype=torch.long, device="meta")
        unet = count_flops(lambda: m["unet"](lat, torch.zeros((), device="meta"), ctx))
        return (self.steps * unet + count_flops(lambda: m["text"](ids))
                + count_flops(lambda: m["vae"](lat)))

    def step_work(self) -> dict:
        """(FLOPs, bytes) of each long self-attention (over more than 256
        tokens) and each GEGLU FFN sub-block of one UNet forward, from the
        configuration's shapes: the first transformer's self-attention sees
        the latent batch, everything after the first cross-attention the
        three conditionings."""
        u, b = self.cell.config["unet"], self.batch
        heads, chs = u["attention_head_dim"], u["block_out_channels"]
        blocks = []  # (channels, tokens) of each transformer, in forward order
        side = self.h * self.w
        for i, kind in enumerate(u["down_block_types"]):
            if kind.startswith("CrossAttn"):
                blocks += [(chs[i], side >> (2 * i))] * u["layers_per_block"]
        n = len(chs)
        blocks.append((chs[-1], side >> (2 * (n - 1))))
        for i, kind in enumerate(u["up_block_types"]):
            if kind.startswith("CrossAttn"):
                blocks += [(chs[n - 1 - i], side >> (2 * (n - 1 - i)))] * (u["layers_per_block"] + 1)
        attn, ffn = [], []
        for j, (ch, tokens) in enumerate(blocks):
            if tokens > 256:
                attn.append(attention_work(b if j == 0 else 3 * b, heads, tokens, tokens,
                                           ch // heads))
            ffn.append(geglu_ffn_work(3 * b * tokens, ch, 4 * ch))
        return {"attention": attn, "ffn": ffn}
