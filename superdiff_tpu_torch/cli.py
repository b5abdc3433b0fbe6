"""Experiment CLI of the port (``superdiff_tpu/cli.py``):

  python -m superdiff_tpu_torch.cli cifar --mode train --config vpsde --workdir w
  python -m superdiff_tpu_torch.cli cifar --mode eval_joint_fid --chkpts a,b --stoch
  python -m superdiff_tpu_torch.cli sd --method and --obj "a cat" --bg "a dog"
  python -m superdiff_tpu_torch.cli protein --length 100 --operator OR

``cifar``: training, single-model and joint FID, dataset statistics.
``sd``: two-prompt SD composition (``--preset tiny`` for a small random
stack, its attention and FFN plain PyTorch as the kernels take only SD's
widths), latents, images and the CLIP / ImageReward metrics where their
weights are local. ``protein``: SE(3) composition of model a (the Proteus
role, kappa weights it) and model b (the FrameDiff role). A reference
checkpoint pickle (``.pkl`` / ``.pth`` / ``.pt``) in ``--ckpt_a`` /
``--ckpt_b`` loads into the checkpoint-faithful Proteus or FrameDiff
network (Proteus recognised by its template-embedder keys; a Proteus config
with struct2seq enabled takes its MPNN + ESM conditioner from
``--mpnn_ckpt`` / ``--esm_dir``, drawn where not given); without one, a
randomly initialised ``IPAConfig.proteus_like()`` / ``framediff_like()``
network stands in. Each run writes a config snapshot beside its outputs.
Every command runs on the card unless ``--device cpu`` is given (JAX's
``--platform``). ``--coordinator_address host:port --num_processes N
--process_id i`` (before the command) join a ``torch.distributed`` process
group first, as JAX's do: ``cifar --mode train`` is then data-parallel over
the N processes (NCCL between cards, gloo with ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os


def _snapshot(args, workdir: str):
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config_snapshot.json"), "w") as f:
        json.dump(vars(args), f, indent=2, default=str)


def proteus_feats(feats: dict) -> dict:
    """The composition's features completed for ``ProteusScoreNetwork`` with
    the reference's inference defaults: an ALA sequence, the ss / adjacency
    / hotspot "mask" categories, zero torsions."""
    import torch
    from torch.nn import functional as F

    b, n = feats["res_mask"].shape
    dev = feats["res_mask"].device
    long = dict(dtype=torch.long, device=dev)
    return {
        "aatype": torch.zeros((b, n), **long),
        "residue_index": feats["seq_idx"].long(),
        "chain_index": torch.zeros((b, n), **long),
        "res_mask": feats["res_mask"],
        "fixed_mask": feats["fixed_mask"],
        "rigids_t": feats["rigids_t"],
        "t": feats["t"],
        "ss": F.one_hot(torch.full((b, n), 3, **long), 4).float(),
        "adjacency": F.one_hot(torch.full((b, n, n), 2, **long), 3).float(),
        "hotspot": F.one_hot(torch.zeros((b, n), **long), 2).float(),
        "torsion_angles_sin_cos": torch.zeros((b, n, 7, 2), device=dev),
    }


def cmd_cifar(args):
    from .pipelines import cifar as C

    cfg = C.CONFIGS[args.config]()
    if args.batch_size:
        cfg.batch_size = args.batch_size
    _snapshot(args, args.workdir)
    dev = args.device
    if args.mode == "train":
        C.train(cfg, args.workdir, n_iters=args.n_iters, device=dev)
    elif args.mode == "eval_fid":
        print(C.evaluate_fid(cfg, args.workdir, stoch=args.stoch, stats_path=args.stats_path,
                             inception_weights=args.inception_weights, device=dev))
    elif args.mode == "eval_joint_fid":
        print(C.evaluate_joint_fid(cfg, args.workdir, args.chkpts.split(","), stoch=args.stoch,
                                   stats_path=args.stats_path,
                                   inception_weights=args.inception_weights, device=dev))
    elif args.mode == "fid_stats":
        print(C.fid_stats(cfg, args.workdir, inception_weights=args.inception_weights,
                          device=dev))
    else:
        raise SystemExit(f"unknown cifar mode {args.mode}")


def cmd_sd(args):
    import numpy as np

    from .eval import clip_metrics
    from .pipelines import sd as S

    cfg = S.SDPipelineConfig(
        num_inference_steps=args.num_inference_steps, guidance_scale=args.guidance_scale,
        height=args.height, width=args.width, temperature=args.T, logp=args.logp,
        lift=args.lift)
    if args.preset == "tiny":
        import dataclasses

        from .models.sd.clip import CLIPTextConfig
        from .models.sd.unet import SDUNetConfig
        from .models.sd.vae import VAEConfig

        # the kernels take SD's widths only (C and F multiples of 64, head
        # dims 40 / 80 / 160); at the tiny widths JAX's wrappers run their
        # plain references, and so does this preset
        unet = dataclasses.replace(SDUNetConfig.tiny(), attn_impl="einsum", ffn_impl="einsum")
        mod = S.build_sd_modules(0, unet_config=unet,
                                 text_config=CLIPTextConfig.tiny(), vae_config=VAEConfig.tiny(),
                                 device=args.device)
    else:
        mod = S.build_sd_modules(0, weights_dir=args.weights_dir, device=args.device)
    _snapshot(args, args.out_dir)
    out = S.generate(mod, args.method, args.obj, args.bg, seed=args.seed,
                     batch_size=args.batch_size, cfg=cfg)
    method_dir = os.path.join(args.out_dir,
                              args.method if args.T == 1 else f"{args.method}_T{args.T}")
    pair = f"{args.obj.replace(' ', '_')}_and_{args.bg.replace(' ', '_')}"
    img_dir = os.path.join(method_dir, pair)
    os.makedirs(img_dir, exist_ok=True)
    images = out["images"].cpu().numpy()
    np.savez_compressed(os.path.join(img_dir, "latents.npz"),
                        latents=out["latents"].float().cpu().numpy())
    try:
        from PIL import Image

        for i, img in enumerate(images):
            Image.fromarray(img).save(os.path.join(img_dir, f"{i}.png"))
    except ImportError:
        np.savez_compressed(os.path.join(img_dir, "images.npz"), images=images)
    metrics = {}
    scorer = clip_metrics.get_clip_scorer()
    if scorer is not None:
        metrics["clip"] = scorer(images, args.obj, args.bg)
    ir = clip_metrics.get_image_reward_scorer()
    if ir is not None:
        metrics["image_reward"] = ir(images, args.obj, args.bg)
    metrics["final_ll_obj"] = out["traces"]["final_ll_obj"].cpu().tolist()
    metrics["final_ll_bg"] = out["traces"]["final_ll_bg"].cpu().tolist()
    mdir = os.path.join(args.out_dir, f"metrics_{args.method}")
    os.makedirs(mdir, exist_ok=True)
    with open(os.path.join(mdir, f"metrics_{args.method}_{pair}.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps({k: v for k, v in metrics.items() if "ll" in k}))


def proteus_model_fn(net, se3):
    """(model_fn, (sc_init, sc_update)) of a ``ProteusScoreNetwork`` for
    ``pipelines.protein.compose``: :func:`proteus_feats`, scores from the
    predicted frames, and its atom37 output carried as the next step's
    template self-condition."""
    import torch

    from .models.protein import rigid

    def model(feats, t):
        out = net(proteus_feats(feats), self_condition=feats.get("self_cond"),
                  struct2seq=feats.get("struct2seq", False))
        rigids_t = feats["rigids_t"]
        out["rot_score"] = se3.calc_rot_score(rigid.rigid_rotmat(rigids_t),
                                              out["pred_rotmats"], feats["t"][:, None])
        out["trans_score"] = se3.calc_trans_score(rigid.rigid_trans(rigids_t),
                                                  out["pred_trans"], feats["t"][:, None, None])
        return out

    def sc_init(init_rigids):
        b, n = init_rigids.shape[:2]
        dev = init_rigids.device
        return {"final_atom_positions": torch.zeros((b, n, 37, 3), device=dev),
                "final_atom_mask": torch.zeros((b, n, 37), device=dev), "active": 0.0}

    def sc_update(out):
        return {"final_atom_positions": out["final_atom_positions"],
                "final_atom_mask": out["final_atom_mask"], "active": 1.0}

    return model, (sc_init, sc_update)


def net_model_fn(net):
    """The model_fn of a network that returns its own scores (IPA,
    FrameDiff)."""
    return lambda feats, t: net(feats)


def build_protein_model(ckpt, fallback_cfg_fn, se3, seed: int, device, struct2seq_opts=None):
    """(model_fn, sc_adapter or None) for the composition.

    A reference torch pickle loads into ``ProteusScoreNetwork`` (detected
    by its ``embedding_layer.template_embedder`` keys) or
    ``FrameDiffScoreNetwork``, built from the checkpoint's embedded model
    config, by ``load_state_dict`` (strict). A Proteus config with
    struct2seq enabled gets its MPNN + ESM conditioner from
    ``struct2seq_opts`` ({mpnn_ckpt, esm_dir, seq_nums}; the combiner heads
    from the checkpoint); the composition's ``esm_rate`` gates it per step.
    No checkpoint gives an
    ``IPAScoreNetwork`` of ``fallback_cfg_fn()`` drawn with the Flax
    initialisers' distributions from ``seed``. A directory is the JAX
    package's own (Orbax) format: it raises, as does a missing file."""
    import torch

    from .models.from_jax import init_like_flax_
    from .models.protein import IPAScoreNetwork

    if ckpt:
        if os.path.isdir(ckpt):
            raise SystemExit(
                f"{ckpt} is a directory: an Orbax checkpoint of the JAX package. Carry its "
                "params into the port with superdiff_tpu_torch.models.from_jax."
                "protein_net_from_flax and pass the network, or give a reference .pkl")
        if not os.path.exists(ckpt):
            raise SystemExit(f"checkpoint not found: {ckpt}")
        from .models.protein import convert

        sd, conf = convert.load_torch_checkpoint(ckpt)
        mc = conf.get("model", {}) if isinstance(conf, dict) else {}
        if any(k.startswith("embedding_layer.template_embedder") for k in sd):
            from .models.protein.proteus import ProteusConfig, ProteusScoreNetwork

            cfg = ProteusConfig.from_ckpt_conf(mc) if mc else ProteusConfig()
            s2s = None
            if cfg.struct2seq_enable:
                from .models.protein import struct2seq

                opts = struct2seq_opts or {}
                s2s = struct2seq.load_mpnn_esm(
                    sd, c_s=cfg.node_embed_size, c_z=cfg.edge_embed_size,
                    mpnn_ckpt=opts.get("mpnn_ckpt"), esm_dir=opts.get("esm_dir"),
                    seq_nums=opts.get("seq_nums", 4), device=device)
            net = ProteusScoreNetwork(cfg, s2s)
            net.load_state_dict(sd, strict=True)
            net = net.to(device).eval()
            print(f"loaded Proteus checkpoint {ckpt}: {len(sd)} tensors")
            return proteus_model_fn(net, se3)
        from .models.protein.framediff import FrameDiffConfig, FrameDiffScoreNetwork

        net = FrameDiffScoreNetwork(FrameDiffConfig.from_ckpt_conf(mc) if mc
                                    else FrameDiffConfig(), score_calc=se3)
        net.load_state_dict(sd, strict=True)
        net = net.to(device).eval()
        print(f"loaded FrameDiff checkpoint {ckpt}: {len(sd)} tensors")
        return net_model_fn(net), None

    with torch.device(device):
        net = IPAScoreNetwork(fallback_cfg_fn(), se3)
    init_like_flax_(net, torch.Generator(device=device).manual_seed(seed))
    return net_model_fn(net.eval()), None


def cmd_protein(args):
    from .models.protein import IPAConfig, SE3Diffuser, backbone
    from .pipelines.protein import CompositionConfig, compose

    if args.mpnn_ckpt and not os.path.isfile(args.mpnn_ckpt):
        raise SystemExit(f"--mpnn_ckpt not found: {args.mpnn_ckpt}")
    if args.esm_dir and not os.path.isdir(args.esm_dir):
        raise SystemExit(f"--esm_dir not found: {args.esm_dir}")
    if args.seq_nums < 1:
        raise SystemExit("--seq_nums must be >= 1")
    if args.batch < 1:
        raise SystemExit("--batch must be >= 1")
    if args.num_t < 2:
        raise SystemExit("--num_t must be >= 2 (one stepped interval)")
    try:
        lengths_list = [int(x) for x in args.lengths.split(",")] if args.lengths else None
    except ValueError:
        raise SystemExit(f"--lengths must be a comma list of ints, got {args.lengths!r}")

    se3 = SE3Diffuser.default(device=args.device)
    cfg = CompositionConfig(
        num_t=args.num_t, min_t=args.min_t,
        mixing_method=args.mixing_method, kappa_operator=args.operator,
        temp_trans=args.temp_trans, temp_rots=args.temp_rots,
        logp_trans=args.logp_trans, logp_rots=args.logp_rots,
        noise_scale=args.noise_scale, stochastic=args.stochastic,
        esm_rate=args.esm_rate,
    )
    _snapshot(args, args.out_dir)
    model_a, sc_adapter_a = build_protein_model(
        args.ckpt_a, IPAConfig.proteus_like, se3, 1, args.device,
        struct2seq_opts={"mpnn_ckpt": args.mpnn_ckpt, "esm_dir": args.esm_dir,
                         "seq_nums": args.seq_nums})
    model_b, sc_adapter_b = build_protein_model(args.ckpt_b, IPAConfig.framediff_like, se3, 2,
                                                args.device)

    # seed series over lengths (the reference protocol: 50 seeds x lengths
    # {100, 150, 200, 250, 300})
    for length in lengths_list or [args.length]:
        for seed in range(args.seed, args.seed + args.num_seeds):
            out_path = os.path.join(args.out_dir, f"len_{length}_seed_{seed}.pdb")
            if os.path.exists(out_path) and not args.overwrite:
                print(f"skip existing {out_path}")
                continue
            out = compose(model_a, model_b, se3, n_res=length, cfg=cfg, batch=args.batch,
                          sc_adapter_a=sc_adapter_a, sc_adapter_b=sc_adapter_b, seed=seed)
            tr = {k: v.cpu() for k, v in out["traces"].items()}
            atom37 = out["atom37"].cpu()
            for b in range(args.batch):
                path_b = out_path if b == 0 else out_path.replace(".pdb", f"_{b}.pdb")
                with open(path_b, "w") as f:
                    f.write(backbone.to_pdb(atom37[b]))
                print(json.dumps({
                    "length": length,
                    "seed": seed,
                    "batch_index": b,
                    "kappa_trans_last": float(tr["kappa_trans"][-1, b]),
                    "ll_a_trans": float(tr["ll_a_trans"][-1, b]),
                    "ll_b_trans": float(tr["ll_b_trans"][-1, b]),
                    "pdb": path_b,
                }))


def _device_arg(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device (the card by default; cpu for a run without one)")


def build_parser() -> argparse.ArgumentParser:
    from .pipelines.sd import METHODS

    p = argparse.ArgumentParser(prog="superdiff_tpu_torch")
    # multi-process runs (parallel/distributed.py): the TCP rendezvous of
    # torch.distributed, NCCL with --device cuda, gloo with --device cpu
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of rank 0's rendezvous (multi-process runs)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("cifar", help="CIFAR train/eval (cifar/main.py modes)")
    c.add_argument("--mode", required=True,
                   choices=["train", "eval_fid", "eval_joint_fid", "fid_stats"])
    c.add_argument("--config", default="vpsde",
                   choices=["vpsde", "vpsdeA", "vpsdeB", "vpsde_less_5", "vpsde_more_5"])
    c.add_argument("--workdir", default="./runs/cifar")
    c.add_argument("--chkpts", default="", help="comma-separated checkpoint dirs for joint eval")
    c.add_argument("--stoch", action="store_true")
    c.add_argument("--n_iters", type=int, default=None)
    c.add_argument("--batch_size", type=int, default=None)
    c.add_argument("--stats_path", default=None)
    c.add_argument("--inception_weights", default=None)
    _device_arg(c)
    c.set_defaults(fn=cmd_cifar)

    s = sub.add_parser("sd", help="Stable-Diffusion composition (clip_eval.py)")
    s.add_argument("--method", default="and", choices=list(METHODS))
    s.add_argument("--obj", default="a cat")
    s.add_argument("--bg", default="a dog")
    s.add_argument("--num_inference_steps", type=int, default=1000)
    s.add_argument("--seed", type=int, default=1)
    s.add_argument("--batch_size", type=int, default=6)
    s.add_argument("--height", type=int, default=512)
    s.add_argument("--width", type=int, default=512)
    s.add_argument("--T", type=float, default=1.0)
    s.add_argument("--logp", type=float, default=0.0)
    s.add_argument("--lift", type=float, default=0.0)
    s.add_argument("--guidance_scale", type=float, default=7.5)
    s.add_argument("--weights_dir", default=None)
    s.add_argument("--preset", default="sd15", choices=["sd15", "tiny"],
                   help="tiny = 1/16-width stack for smoke runs without weights")
    s.add_argument("--out_dir", default="./runs/sd")
    _device_arg(s)
    s.set_defaults(fn=cmd_sd)

    pr = sub.add_parser("protein", help="SE(3) composition (superdiff/inference.py)")
    pr.add_argument("--length", type=int, default=100)
    pr.add_argument("--lengths", default=None,
                    help="comma list for a series run, e.g. 100,150,200,250,300")
    pr.add_argument("--num_t", type=int, default=500)
    pr.add_argument("--min_t", type=float, default=0.002)
    pr.add_argument("--mixing_method", default="composition",
                    choices=["composition", "mixture", "baseline_a", "baseline_b"])
    pr.add_argument("--operator", default="OR", choices=["OR", "AND"])
    pr.add_argument("--temp_trans", type=float, default=1.0)
    pr.add_argument("--temp_rots", type=float, default=1.0)
    pr.add_argument("--logp_trans", type=float, default=0.0)
    pr.add_argument("--logp_rots", type=float, default=0.0)
    pr.add_argument("--noise_scale", type=float, default=0.1)
    pr.add_argument("--stochastic", action="store_true")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--num_seeds", type=int, default=1)
    pr.add_argument("--batch", type=int, default=1, help="trajectories per seed")
    pr.add_argument("--ckpt_a", default=None)
    pr.add_argument("--ckpt_b", default=None)
    pr.add_argument("--esm_rate", type=float, default=0.0,
                    help="fraction of steps with struct2seq / ESM conditioning on the "
                    "proteus-role model")
    pr.add_argument("--mpnn_ckpt", default=None,
                    help="ProteinMPNN CA weights file (v_48_020.pt) for struct2seq")
    pr.add_argument("--esm_dir", default=None,
                    help="local transformers ESM2 snapshot dir for struct2seq")
    pr.add_argument("--seq_nums", type=int, default=4,
                    help="sequences sampled per struct2seq call")
    pr.add_argument("--overwrite", action="store_true")
    pr.add_argument("--out_dir", default="./runs/protein")
    _device_arg(pr)
    pr.set_defaults(fn=cmd_protein)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.coordinator_address or args.num_processes:
        from .parallel.distributed import initialize

        initialize(
            coordinator_address=args.coordinator_address,
            num_processes=args.num_processes,
            process_id=args.process_id,
            device=args.device,
        )
    args.fn(args)


if __name__ == "__main__":
    main()
