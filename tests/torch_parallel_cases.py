"""What each rank of the parallel tests runs (``tests/torch_dist.py``): one
function a case, taking the inputs the test saved and returning plain
tensors and numbers. Torch and the port only; the JAX side stays in the
test process."""

import torch
import torch.distributed as dist

from superdiff_tpu_torch.parallel import distributed as D
from superdiff_tpu_torch.parallel import mesh as M

torch.backends.cudnn.allow_tf32 = False


def topology(inp):
    """The process topology, a reduction over the data axes and the
    host-sharded Kronecker sequence (JAX's ``tests/_multihost_child.py``)."""
    from superdiff_tpu_torch.core.dsm import kronecker_times

    D.initialize(inp["address"], dist.get_world_size(), dist.get_rank(), device="cpu")
    mesh = M.make_multihost_mesh()
    axes = M.dp_axes(mesh)
    rows = M.shard_batch(torch.arange(16, dtype=torch.float32).reshape(16, 1), mesh)
    total = mesh.all_reduce(rows.sum(), axes)
    n, i = D.host_shard_info()
    t, _ = kronecker_times(4, torch.tensor(0.5), 0.0, 1.0, num_shards=n, shard_index=i)
    return {
        "rank": dist.get_rank(), "world": dist.get_world_size(),
        "is_coordinator": D.is_coordinator(), "shard_info": (n, i),
        "mesh_axes": dict(mesh.shape), "coords": dict(mesh.coords),
        "data_sharding": M.data_sharding(mesh),
        "global_mean": float(total) / 16,
        "kronecker_all": mesh.all_gather(t, axes).tolist(),
    }


def _train_net(inp):
    """The net of a DP case and its ``apply_fn``: the MLP score net
    (``inp["mlp"]`` its hidden widths) or a ScoreUNet of ``inp["cfg"]``."""
    from superdiff_tpu_torch.models.mlp import MLPScoreNet
    from superdiff_tpu_torch.pipelines import cifar

    if inp.get("mlp"):
        net = MLPScoreNet(hidden=inp["mlp"], out_dim=2)
        apply_fn = lambda t, x, y, generator=None: net(t, x)  # noqa: E731
    else:
        net = cifar.CifarConfig(**inp["cfg"]).model()
        apply_fn = cifar._apply_fn(net)
    net.load_state_dict(inp["params"])
    return net, apply_fn


def dp_train(inp):
    """``make_train_step(mesh=make_mesh(data=W))`` for a few steps on
    global batches (with ``eps`` when given); the losses and the state
    after the last step."""
    from superdiff_tpu_torch.core.dsm import make_dsm_loss
    from superdiff_tpu_torch.core.schedules import VPSchedule
    from superdiff_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    net, apply_fn = _train_net(inp)
    mesh = M.make_mesh(model=1)
    n, i = M.data_sharding(mesh)
    if not inp.get("mlp"):
        net.shard_dropout(n, i)
    opt = make_optimizer(inp["lr"], inp["warmup"], grad_clip=inp["clip"])
    state = init_train_state(torch.Generator().manual_seed(inp["seed"]), net, opt,
                             ema_rate=inp["ema"])
    loss_fn = make_dsm_loss(apply_fn, VPSchedule(), num_shards=n, shard_index=i)
    step = make_train_step(opt, loss_fn, mesh=mesh, donate=True)
    losses = []
    for k, b in enumerate(inp["batches"]):
        eps = None if inp["eps"] is None else inp["eps"][k]
        state, loss = step(state, {"image": b}, eps=eps)
        losses.append(loss.item())
    adam = state.optimizer.state_dict()["state"]
    return {
        "losses": losses, "step": state.step, "sampler_state": state.sampler_state.clone(),
        "params": {k: v.detach().clone() for k, v in net.state_dict().items()},
        "ema": {k: v.clone() for k, v in state.params_ema.items()},
        "adam": [(s["exp_avg"].clone(), s["exp_avg_sq"].clone()) for _, s in sorted(adam.items())],
        "rng": state.generator.get_state(),
    }


def ensemble_scores(inp):
    """The stacked oracle under ``mode`` on a mesh of ``model`` ranks."""
    from superdiff_tpu_torch.models.ensemble import make_stacked_score_fn
    from superdiff_tpu_torch.pipelines import cifar

    cfg = cifar.CifarConfig(**inp["cfg"])
    nets = cifar.build_cifar_models(inp["params"], cfg, device="cpu")
    mesh = M.make_mesh(model=inp["model"])
    called = []
    for k, net in enumerate(nets):
        net.register_forward_hook(lambda *_, k=k: called.append(k))
    fn = make_stacked_score_fn(nets, labels=inp["labels"], mode=inp["mode"], mesh=mesh)
    with torch.no_grad():
        out = fn(torch.tensor(inp["t"]), inp["x"])
    return {"scores": out, "called": sorted(set(called)), "coords": dict(mesh.coords)}


def ensemble_generator(inp):
    """``make_generator`` on a data x model mesh: injected noise, then the
    generator's own draws."""
    from superdiff_tpu_torch.pipelines import cifar

    cfg = cifar.CifarConfig(**inp["cfg"])
    nets = cifar.build_cifar_models(inp["params"], cfg, device="cpu")
    mesh = M.make_mesh(model=inp["model"])
    gen = cifar.make_generator(nets, cfg, mode=inp["mode"], operator=inp["operator"],
                               n_steps=inp["steps"], labels=inp["labels"],
                               score_mode=inp["score_mode"], mesh=mesh)
    x0, logq = gen(noise=inp["noise"])
    y0, logq_drawn = gen(torch.Generator().manual_seed(inp["seed"]))
    return {"x0": x0, "logq": logq, "drawn": (y0, logq_drawn), "mesh": dict(mesh.shape)}


class CollectiveCounter:
    """Counts the calls of ``torch.distributed``'s collectives while in
    use (the port's layers look them up at call time)."""

    NAMES = ("all_reduce", "all_gather_into_tensor", "all_gather", "broadcast",
             "reduce_scatter_tensor", "all_to_all", "batch_isend_irecv", "send", "recv")

    def __enter__(self):
        self.counts = dict.fromkeys(self.NAMES, 0)
        self.saved = {n: getattr(dist, n) for n in self.NAMES}
        for n in self.NAMES:
            def wrapped(*a, _n=n, **k):
                self.counts[_n] += 1
                return self.saved[_n](*a, **k)
            setattr(dist, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(dist, n, f)


def _sd_unet(inp):
    from superdiff_tpu_torch.models.sd.unet import SDUNet, SDUNetConfig

    import dataclasses

    cfg = dataclasses.replace(SDUNetConfig.tiny(), **inp.get("impl", {}))
    net = SDUNet(cfg, dtype=torch.float32)
    net.load_state_dict(inp["params"])
    return net.eval()


def tp_forward(inp):
    """The TP UNet forward on a (data, tp) mesh; the batch split over data
    and gathered back; the collectives of the forward counted."""
    from superdiff_tpu_torch.parallel import tp as T

    mesh = T.make_tp_mesh(inp["data"], inp["tp"])
    net = T.place_tp(_sd_unet(inp), mesh)
    x, ctx = M.shard_batch(inp["x"], mesh), M.shard_batch(inp["ctx"], mesh)
    with torch.no_grad(), CollectiveCounter() as cc:
        out = net(x, torch.tensor(500.0), ctx)
    out = mesh.all_gather(out, "data")
    specs = T.sd_tp_shardings(net, mesh)
    return {"out": out, "counts": cc.counts, "specs": specs,
            "shapes": {k: tuple(v.shape) for k, v in net.named_parameters()}}


def tp_rules(inp):
    """The rule table's fallback on an indivisible dim, and place_tp on a
    kernel configuration."""
    from superdiff_tpu_torch.parallel import tp as T

    mesh = T.make_tp_mesh(1, dist.get_world_size())
    odd = {"block_0.attn1.to_q.weight": torch.zeros(62, 64),
           "block_0.attn1.to_k.weight": torch.zeros(64, 64)}
    try:
        T.place_tp(_sd_unet(dict(inp, impl={})), mesh)
        raised = None
    except ValueError as e:
        raised = str(e)
    return {"odd": T.sd_tp_shardings(odd, mesh), "raised": raised}


def tp_sampler(inp):
    """The 3-step OR sampler with the UNet TP-split over the world."""
    import dataclasses

    from superdiff_tpu_torch.models.sd.clip import CLIPTextConfig
    from superdiff_tpu_torch.models.sd.unet import SDUNetConfig
    from superdiff_tpu_torch.models.sd.vae import VAEConfig
    from superdiff_tpu_torch.parallel import tp as T
    from superdiff_tpu_torch.pipelines import sd

    mod = sd.build_sd_modules(
        0, unet_config=dataclasses.replace(SDUNetConfig.tiny(), upsample_impl="repeat",
                                           attn_impl="einsum", ffn_impl="einsum"),
        text_config=CLIPTextConfig.tiny(), vae_config=VAEConfig.tiny(),
        device="cpu", dtype=torch.float32)
    for m, k in ((mod.unet, "unet"), (mod.text, "text"), (mod.vae, "vae")):
        m.load_state_dict(inp[k])
    mesh = T.make_tp_mesh(1, dist.get_world_size())
    T.place_tp(mod.unet, mesh)
    got = sd.generate(mod, "or", "a cat", "a dog", seed=0, batch_size=inp["batch"],
                      cfg=inp["cfg"], noise=inp["noise"], decode=False)
    return {"latents": got["latents"], "kappa": got["traces"]["kappa"]}


def tp_ensemble(inp):
    """3-axis (data, model, tp): each model group runs its own UNet, split
    over tp; the per-model outputs all-gathered over model."""
    from superdiff_tpu_torch.models.ensemble import stack_params
    from superdiff_tpu_torch.parallel import tp as T

    mesh = T.make_ensemble_tp_mesh(inp["data"], inp["model"], inp["tp"])
    i = mesh.coords["model"]
    net = T.place_tp(_sd_unet(dict(inp, params=inp["params"][i])), mesh)
    x, ctx = M.shard_batch(inp["x"], mesh), M.shard_batch(inp["ctx"], mesh)
    with torch.no_grad():
        out = net(x, torch.tensor(500.0), ctx)
    out = mesh.all_gather(mesh.all_gather(out, "data")[None], "model")
    stacked = stack_params([_sd_unet(dict(inp, params=p)) for p in inp["params"]])
    return {"out": out, "specs": T.sd_tp_shardings_stacked(stacked, mesh)}


def ring(inp):
    """``ring_attention`` over a mesh of ``axes``; a ValueError's message
    where it raises."""
    from superdiff_tpu_torch.parallel import sp

    mesh = M.Mesh(inp["axes"])
    try:
        with CollectiveCounter() as cc:
            out = sp.ring_attention(*inp["qkv"], mesh, sm_scale=inp.get("scale"),
                                    batch_axis=inp.get("batch_axis"))
    except ValueError as e:
        return {"raised": str(e)}
    return {"out": out, "counts": cc.counts}


def _mlp_stage(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def pipe(inp):
    """``pipeline`` of the residual MLP stages (stacked dict) over the
    world: the output, and the gradients of sum(out^2) w.r.t. the stacked
    params and x (each stage's gradient rows summed over the ranks)."""
    import warnings

    from superdiff_tpu_torch.parallel import pp

    mesh = M.Mesh((("pp", dist.get_world_size()),))
    params = {k: v.clone().requires_grad_(True) for k, v in inp["params"].items()}
    x = inp["x"].clone().requires_grad_(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = pp.pipeline(_mlp_stage, params, x, mesh, n_micro=inp.get("n_micro"))
        except ValueError as e:
            return {"raised": str(e)}
    (out ** 2).sum().backward()
    grads = {k: mesh.all_reduce(v.grad.clone(), "pp") for k, v in params.items()}
    return {"out": out.detach(), "grads": grads, "x_grad": x.grad.clone(),
            "warnings": [str(w.message) for w in caught]}


def pipe_framediff(inp):
    """The FrameDiff seq-transformer trunk pipelined one layer a rank."""
    from superdiff_tpu_torch.models.protein.framediff import TorchTransformerLayer
    from superdiff_tpu_torch.parallel import pp

    n = dist.get_world_size()
    mesh = M.Mesh((("pp", n),))
    layers = []
    for sd_ in inp["layers"]:
        layer = TorchTransformerLayer(inp["d"], inp["heads"])
        layer.load_state_dict(sd_)
        layers.append(layer)

    def stage(layer, xx):
        return layer(xx, torch.ones(xx.shape[:2]))

    x = inp["x"].clone().requires_grad_(True)
    out = pp.pipeline(stage, layers, x, mesh, n_micro=inp["n_micro"])
    (out ** 2).sum().backward()
    mine = layers[mesh.coords["pp"]]
    grads = {k: v.grad.clone() for k, v in mine.named_parameters()}
    return {"out": out.detach(), "grads": grads, "x_grad": x.grad.clone()}


def cli_train(inp):
    """``cli.main`` with the multi-process flags: ``cifar --mode train`` of
    a tiny config (``CONFIGS`` swapped) in a process group it joins."""
    import os

    from superdiff_tpu_torch import cli
    from superdiff_tpu_torch.pipelines import cifar

    cifar.CONFIGS["vpsde"] = lambda **kw: cifar.CifarConfig(**{**inp["cfg"], **kw})
    train, kept = cifar.train, {}
    cifar.train = lambda *a, **k: kept.setdefault("state", train(*a, **k))
    rank = os.environ["TORCH_DIST_RANK"]
    workdir = os.path.join(inp["workdir"], "shared")
    cli.main(["--coordinator_address", os.environ["TORCH_DIST_ADDRESS"],
              "--num_processes", os.environ["TORCH_DIST_WORLD"], "--process_id", rank,
              "cifar", "--mode", "train", "--device", "cpu", "--workdir", workdir,
              "--n_iters", str(inp["n_iters"])])
    dist.barrier()  # rank 0's files are written
    state = kept["state"]
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "files": sorted(os.listdir(workdir)),
            "checkpoints": sorted(os.listdir(os.path.join(workdir, "checkpoints"))),
            "params": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "step": state.step}
