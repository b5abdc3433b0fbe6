"""Experiment CLI of the port (``superdiff_tpu/cli.py``'s ``protein``
subcommand; ``cifar`` and ``sd`` are not ported yet):

  python -m superdiff_tpu_torch.cli protein --length 100 --operator OR

SE(3) protein composition: model a (the Proteus role, kappa weights it) and
model b (the FrameDiff role) composed along one reverse trajectory. A
reference checkpoint pickle (``.pkl`` / ``.pth`` / ``.pt``) in ``--ckpt_a``
/ ``--ckpt_b`` loads into the checkpoint-faithful Proteus or FrameDiff
network (Proteus recognised by its template-embedder keys); without one,
a randomly initialised ``IPAConfig.proteus_like()`` / ``framediff_like()``
network stands in. Each run writes a config snapshot, one PDB per
backbone and one JSON line per backbone on standard output. Runs on the
card unless ``--device cpu`` is given.
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


def proteus_model_fn(net, se3):
    """(model_fn, (sc_init, sc_update)) of a ``ProteusScoreNetwork`` for
    ``pipelines.protein.compose``: :func:`proteus_feats`, scores from the
    predicted frames, and its atom37 output carried as the next step's
    template self-condition."""
    import torch

    from .models.protein import rigid

    def model(feats, t):
        out = net(proteus_feats(feats), self_condition=feats.get("self_cond"))
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


def build_protein_model(ckpt, fallback_cfg_fn, se3, seed: int, device):
    """(model_fn, sc_adapter or None) for the composition.

    A reference torch pickle loads into ``ProteusScoreNetwork`` (detected
    by its ``embedding_layer.template_embedder`` keys) or
    ``FrameDiffScoreNetwork``, built from the checkpoint's embedded model
    config, by ``load_state_dict`` (strict). No checkpoint gives an
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

            net = ProteusScoreNetwork(ProteusConfig.from_ckpt_conf(mc) if mc
                                      else ProteusConfig())
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


# the struct2seq options, which JAX's parser takes; any other value raises
STRUCT2SEQ_DEFAULTS = {"mpnn_ckpt": None, "esm_dir": None, "seq_nums": 4}


def cmd_protein(args):
    from .models.protein import IPAConfig, SE3Diffuser, backbone
    from .pipelines.protein import CompositionConfig, compose

    s2s = [f"--{k}" for k, v in STRUCT2SEQ_DEFAULTS.items() if getattr(args, k) != v]
    if s2s:
        raise NotImplementedError(f"{', '.join(s2s)} configure struct2seq "
                                  f"(models/protein/struct2seq.py), which is not ported yet")
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
    model_a, sc_adapter_a = build_protein_model(args.ckpt_a, IPAConfig.proteus_like, se3, 1,
                                                args.device)
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="superdiff_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
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
                    "proteus-role model (needs struct2seq, not ported yet)")
    pr.add_argument("--mpnn_ckpt", default=STRUCT2SEQ_DEFAULTS["mpnn_ckpt"],
                    help="ProteinMPNN CA weights for struct2seq (not ported yet: raises)")
    pr.add_argument("--esm_dir", default=STRUCT2SEQ_DEFAULTS["esm_dir"],
                    help="local ESM2 snapshot dir for struct2seq (not ported yet: raises)")
    pr.add_argument("--seq_nums", type=int, default=STRUCT2SEQ_DEFAULTS["seq_nums"],
                    help="sequences sampled per struct2seq call (not ported yet: raises "
                    "when it differs from the default)")
    pr.add_argument("--overwrite", action="store_true")
    pr.add_argument("--out_dir", default="./runs/protein")
    pr.add_argument("--device", default="cuda",
                    help="torch device (the card by default; cpu for a run without one)")
    pr.set_defaults(fn=cmd_protein)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
