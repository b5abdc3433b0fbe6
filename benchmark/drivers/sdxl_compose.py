"""Traffic of SDXL prompt composition: as ``sd_compose`` (requests of one
prompt pair each, served back to back by
``superdiff_tpu_torch.pipelines.sd.generate``), on the SDXL stack: two
text towers, whose penultimate states form the 2048-wide context and whose
second's pooled output and the size ids enter the UNet's time embedding,
and the UNet's per-level transformer depth at head dim 64.

Spans and the check are ``sd_compose``'s: the hooks on both towers mark
the encodings, the configuration's reference (which runs the UNet on every
conditioning's copy of the latents) gives the compared latents,
log-likelihood traces and images.
"""

from __future__ import annotations

import torch

from benchmark.drivers.sd_compose import Driver as SDDriver
from benchmark.harness.yardstick import attention_work, count_flops, geglu_ffn_work


def text_config(t: dict):
    """The program's config of a tower from its published config, read
    as SDXL reads it (penultimate states; pooled where it projects)."""
    from superdiff_tpu_torch.models.sd.clip import CLIPTextConfig

    projected = t["architectures"][0].endswith("WithProjection")
    return CLIPTextConfig(vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                          num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                          max_length=t["max_position_embeddings"], hidden_act=t["hidden_act"],
                          projection_dim=t["projection_dim"] if projected else 0,
                          output="penultimate")


class Driver(SDDriver):
    # ------------------------------------------------------------ program
    def build(self, state):
        from superdiff_tpu_torch.models.sd.clip import CLIPTextEncoder, Tokenizer
        from superdiff_tpu_torch.models.sd.unet import SDUNet, SDUNetConfig
        from superdiff_tpu_torch.models.sd.vae import VAEConfig, VAEDecoder
        from superdiff_tpu_torch.pipelines.sd import SDModules, SDPipelineConfig

        c, t = self.cell.config, self.cell.traffic
        u, v, m = c["unet"], c["vae"], c["method"]
        dtype = getattr(torch, c["dtype"])
        ucfg = SDUNetConfig(
            in_channels=u["in_channels"], out_channels=u["out_channels"],
            block_out_channels=tuple(u["block_out_channels"]),
            layers_per_block=u["layers_per_block"], cross_attention_dim=u["cross_attention_dim"],
            attention_head_dim=tuple(u["attention_head_dim"]),
            transformer_layers_per_block=tuple(u["transformer_layers_per_block"]),
            down_block_types=tuple(u["down_block_types"]),
            up_block_types=tuple(u["up_block_types"]),
            addition_embed_type=u["addition_embed_type"],
            addition_time_embed_dim=u["addition_time_embed_dim"],
            projection_class_embeddings_input_dim=u["projection_class_embeddings_input_dim"])
        tl, tg = text_config(c["text_encoder"]), text_config(c["text_encoder_2"])
        base = v["block_out_channels"][0]
        vcfg = VAEConfig(latent_channels=v["latent_channels"], base_channels=base,
                         channel_mults=tuple(ch // base for ch in v["block_out_channels"]),
                         layers_per_block=v["layers_per_block"], scaling_factor=v["scaling_factor"])
        with torch.device(self.device):
            parts = {"unet": SDUNet(ucfg, dtype=dtype), "text": CLIPTextEncoder(tl, dtype=dtype),
                     "text_2": CLIPTextEncoder(tg, dtype=dtype),
                     "vae": VAEDecoder(vcfg, out_channels=v["out_channels"], dtype=dtype)}
        for name, mod in parts.items():
            mod.load_state_dict(state[name], strict=True)
            mod.eval().requires_grad_(False)
        self.mod = SDModules(
            unet=parts["unet"], text=parts["text"], tokenizer=Tokenizer(tl), vae=parts["vae"],
            vae_scaling=v["scaling_factor"], device=torch.device(self.device),
            text_2=parts["text_2"], tokenizer_2=Tokenizer(tg, pad_id=0),
            force_zeros_for_empty_prompt=c["force_zeros_for_empty_prompt"])
        self.pcfg = SDPipelineConfig(
            num_inference_steps=self.steps, guidance_scale=m["guidance_scale"],
            height=t["height"], width=t["width"], temperature=m["temperature"], logp=m["logp"])
        for tower in (parts["text"], parts["text_2"]):
            tower.register_forward_pre_hook(self._before_encode)
            tower.register_forward_hook(self._after_encode)
        parts["vae"].register_forward_pre_hook(self._before_decode)

    # ---------------------------------------------------------- yardstick
    def model_flops(self, ref) -> int:
        """FLOPs of one request as the plain reference counts them: obj and
        bg through both towers, the UNet a step over the three
        conditionings' rows, the decode."""
        c, b = self.cell.config, self.batch
        m = ref.build(c, "meta")
        u = c["unet"]
        lat = torch.empty((3 * b, self.h, self.w, 4), device="meta")
        ctx = torch.empty((3 * b, c["text_encoder"]["max_position_embeddings"],
                           u["cross_attention_dim"]), device="meta")
        pooled = torch.empty((3 * b, c["text_encoder_2"]["projection_dim"]), device="meta")
        sizes = torch.zeros((6,), device="meta")
        ids = torch.zeros((2 * b, c["text_encoder"]["max_position_embeddings"]),
                          dtype=torch.long, device="meta")
        unet = count_flops(lambda: m["unet"](lat, torch.zeros((), device="meta"), ctx, pooled,
                                             sizes))
        text = count_flops(lambda: (m["text"](ids), m["text_2"](ids)))
        return self.steps * unet + text + count_flops(lambda: m["vae"](lat[:b]))

    def step_work(self) -> dict:
        """(FLOPs, bytes) of each long self-attention (over more than 256
        tokens) and each GEGLU FFN sub-block of one UNet forward, from the
        configuration's shapes: every transformer block of every level at
        its depth and heads, over the three conditionings' rows (the
        conditioning enters through the time embedding, so no row is
        shared past ``conv_in``)."""
        u, b = self.cell.config["unet"], self.batch
        heads, depth = u["attention_head_dim"], u["transformer_layers_per_block"]
        chs, lpb, n = u["block_out_channels"], u["layers_per_block"], len(u["block_out_channels"])
        side = self.h * self.w
        blocks = []  # (level, count) of the attention blocks, in forward order
        for i, kind in enumerate(u["down_block_types"]):
            if kind.startswith("CrossAttn"):
                blocks.append((i, lpb * depth[i]))
        blocks.append((n - 1, depth[-1]))
        for i, kind in enumerate(u["up_block_types"]):
            if kind.startswith("CrossAttn"):
                blocks.append((n - 1 - i, (lpb + 1) * depth[n - 1 - i]))
        attn, ffn = [], []
        for level, count in blocks:
            ch, tokens = chs[level], side >> (2 * level)
            for _ in range(count):
                if tokens > 256:
                    attn.append(attention_work(3 * b, heads[level], tokens, tokens,
                                               ch // heads[level]))
                ffn.append(geglu_ffn_work(3 * b * tokens, ch, 4 * ch))
        return {"attention": attn, "ffn": ffn}
