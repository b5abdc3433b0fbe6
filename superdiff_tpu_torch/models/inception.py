"""InceptionV3 (pool3 features + class logits) for FID / IS on the card (port
of ``superdiff_tpu/models/inception.py``).

The reference extracts FID features with Keras InceptionV3
(``include_top=False, pooling='avg'``) after a resize to 299x299 and a
scale to [-1, 1] (``cifar/evaluation.py:6-33``); the Inception Score applies
the network's own final layer to pool3. This is the same network as an
``nn.Module``, inference only:

* BatchNorm (``scale=False``, eps 1e-3, the Keras configuration) is folded
  into each conv's weight and bias when weights are converted, so the net
  is conv + bias + relu throughout.
* The convs are ``convs.0`` .. ``convs.93`` in the Keras graph-construction
  order (how the released h5 files number their layers), the head
  ``predictions``. The JAX package's converted ``.npz``
  (``conv{i}/kernel`` HWIO, ``conv{i}/bias``, ``predictions/kernel`` (in,
  out)) loads through :func:`load_npz` / :func:`load_params`; the Keras
  ``.h5`` converters are copied from the JAX module, with ``h5py`` imported
  only when one is called.
* TF's SAME average pooling leaves the padding out of the divisor
  (``count_include_pad=False``); the 299x299 bilinear resize uses half-pixel
  centres without antialiasing (``jax.image.resize``'s, for an upsample).

The graph is written once (:func:`_graph`) and walked twice: over channel
counts to build the convs, and over tensors to run them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .from_jax import state_dict_from_flax

Params = Dict[str, Dict[str, np.ndarray]]

POOL_DIM = 2048
NUM_CLASSES = 1000
BN_EPS = 1e-3  # Keras BatchNormalization default, used by inception_v3


def _graph(ops, x):
    """The Keras InceptionV3 graph up to pool3's input, its convs in
    ``keras.applications.inception_v3`` source order."""

    def mixed_a(x, pool_filters):
        b1 = ops.conv(x, 64, 1, 1)
        b5 = ops.conv(ops.conv(x, 48, 1, 1), 64, 5, 5)
        b3 = ops.conv(ops.conv(ops.conv(x, 64, 1, 1), 96, 3, 3), 96, 3, 3)
        bp = ops.conv(ops.avg_pool(x), pool_filters, 1, 1)
        return ops.cat([b1, b5, b3, bp])

    def mixed_c(x, c77):
        b1 = ops.conv(x, 192, 1, 1)
        b7 = ops.conv(ops.conv(ops.conv(x, c77, 1, 1), c77, 1, 7), 192, 7, 1)
        bd = ops.conv(x, c77, 1, 1)
        bd = ops.conv(bd, c77, 7, 1)
        bd = ops.conv(bd, c77, 1, 7)
        bd = ops.conv(bd, c77, 7, 1)
        bd = ops.conv(bd, 192, 1, 7)
        bp = ops.conv(ops.avg_pool(x), 192, 1, 1)
        return ops.cat([b1, b7, bd, bp])

    def mixed_e(x):
        b1 = ops.conv(x, 320, 1, 1)
        b3 = ops.conv(x, 384, 1, 1)
        b3 = ops.cat([ops.conv(b3, 384, 1, 3), ops.conv(b3, 384, 3, 1)])
        bd = ops.conv(ops.conv(x, 448, 1, 1), 384, 3, 3)
        bd = ops.cat([ops.conv(bd, 384, 1, 3), ops.conv(bd, 384, 3, 1)])
        bp = ops.conv(ops.avg_pool(x), 192, 1, 1)
        return ops.cat([b1, b3, bd, bp])

    # stem
    x = ops.conv(x, 32, 3, 3, stride=2, valid=True)
    x = ops.conv(x, 32, 3, 3, valid=True)
    x = ops.conv(x, 64, 3, 3)
    x = ops.max_pool(x)
    x = ops.conv(x, 80, 1, 1, valid=True)
    x = ops.conv(x, 192, 3, 3, valid=True)
    x = ops.max_pool(x)
    # mixed 0-2 (35x35)
    x = mixed_a(x, 32)
    x = mixed_a(x, 64)
    x = mixed_a(x, 64)
    # mixed 3 (grid reduce to 17x17)
    b3 = ops.conv(x, 384, 3, 3, stride=2, valid=True)
    bd = ops.conv(ops.conv(x, 64, 1, 1), 96, 3, 3)
    bd = ops.conv(bd, 96, 3, 3, stride=2, valid=True)
    x = ops.cat([b3, bd, ops.max_pool(x)])
    # mixed 4-7 (17x17)
    x = mixed_c(x, 128)
    x = mixed_c(x, 160)
    x = mixed_c(x, 160)
    x = mixed_c(x, 192)
    # mixed 8 (grid reduce to 8x8)
    b3 = ops.conv(ops.conv(x, 192, 1, 1), 320, 3, 3, stride=2, valid=True)
    b7 = ops.conv(ops.conv(ops.conv(x, 192, 1, 1), 192, 1, 7), 192, 7, 1)
    b7 = ops.conv(b7, 192, 3, 3, stride=2, valid=True)
    x = ops.cat([b3, b7, ops.max_pool(x)])
    # mixed 9-10 (8x8)
    x = mixed_e(x)
    return mixed_e(x)


class _Shapes:
    """Walks :func:`_graph` over channel counts, listing each conv's
    (in, out, kh, kw, stride, padding)."""

    def __init__(self):
        self.convs = []

    def conv(self, c, filters, kh, kw, stride=1, valid=False):
        pad = (0, 0) if valid else (kh // 2, kw // 2)  # SAME at stride 1
        self.convs.append((c, filters, kh, kw, stride, pad))
        return filters

    def avg_pool(self, c):
        return c

    def max_pool(self, c):
        return c

    def cat(self, cs):
        return sum(cs)


class _Run:
    """Walks :func:`_graph` over NCHW tensors with the module's convs."""

    def __init__(self, convs: nn.ModuleList):
        self.convs, self.i = convs, 0

    def conv(self, x, *_, **__):
        self.i += 1
        return F.relu(self.convs[self.i - 1](x))

    def avg_pool(self, x):
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)

    def max_pool(self, x):
        return F.max_pool2d(x, 3, 2)

    def cat(self, xs):
        return torch.cat(xs, dim=1)


class InceptionV3(nn.Module):
    """``forward(images, include_top=True, resize=True)``: images (N, H, W,
    3) uint8 or float in [0, 255] -> ``{"pool": (N, 2048) fp32[, "logits":
    (N, 1000) fp32]}``, the reference's preprocessing first (bilinear resize
    to 299, ``x / 127.5 - 1``), all in fp32 (the JAX ``apply``'s default
    dtype)."""

    def __init__(self, include_top: bool = True):
        super().__init__()
        shapes = _Shapes()
        _graph(shapes, 3)
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, (kh, kw), stride=stride, padding=pad)
            for cin, cout, kh, kw, stride, pad in shapes.convs)
        self.predictions = nn.Linear(POOL_DIM, NUM_CLASSES) if include_top else None

    def load_tree(self, params: Params, strict: bool = True) -> "InceptionV3":
        """Load a JAX-layout parameter tree (``{"conv{i}": {"kernel" HWIO,
        "bias"}, "predictions": {"kernel" (in, out), "bias"}}``)."""
        sd = {k.replace("conv", "convs.", 1) if k.startswith("conv") else k: v
              for k, v in state_dict_from_flax(params).items()}
        if self.predictions is None:
            sd = {k: v for k, v in sd.items() if not k.startswith("predictions")}
        self.load_state_dict(sd, strict=strict)
        return self

    def forward(self, images: torch.Tensor, include_top: bool = True,
                resize: bool = True) -> Dict[str, torch.Tensor]:
        x = images.float().permute(0, 3, 1, 2)
        if resize and tuple(x.shape[2:]) != (299, 299):
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                              antialias=False)
        x = x / 127.5 - 1.0
        pool = _graph(_Run(self.convs), x).mean(dim=(2, 3))
        out = {"pool": pool}
        if include_top and self.predictions is not None:
            out["logits"] = self.predictions(pool)
        return out


def num_convs() -> int:
    return 94


# -- weights -----------------------------------------------------------------


def save_npz(params: Params, path: str) -> None:
    flat = {}
    for name, p in params.items():
        for wn, w in p.items():
            flat[f"{name}/{wn}"] = np.asarray(w)
    np.savez_compressed(path, **flat)


def load_npz(path: str) -> Params:
    """The JAX module's ``.npz`` (``conv{i}/kernel`` ...) as a tree of numpy
    arrays."""
    params: Params = {}
    with np.load(path) as f:
        for key in f.files:
            name, wn = key.rsplit("/", 1)
            params.setdefault(name, {})[wn] = np.asarray(f[key])
    return params


def load_params(path: str) -> Params:
    """Converted params from ``.npz``, or converted from a Keras ``.h5``."""
    if path.endswith(".h5") or path.endswith(".hdf5"):
        return convert_keras_h5(path)
    return load_npz(path)


def build(params: Params, device="cuda") -> InceptionV3:
    """An :class:`InceptionV3` on ``device`` in eval mode carrying
    ``params`` (with the logits head when ``params`` has one)."""
    with torch.device(device):
        model = InceptionV3(include_top="predictions" in params)
    return model.load_tree(params).eval().requires_grad_(False)


def make_feature_fn(params: Params, batch_size: int = 128, with_logits: bool = False,
                    device="cuda"):
    """Batched extractor: uint8 images (N, H, W, 3) numpy -> (N, 2048)
    pool3 features (and, with ``with_logits`` and a logits head, the (N,
    1000) logits), computed on ``device`` ``batch_size`` images at a time."""
    model = build(params, device)
    include_top = with_logits and model.predictions is not None

    @torch.no_grad()
    def feature_fn(images: np.ndarray):
        pools, logits = [], []
        for i in range(0, len(images), batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(images[i:i + batch_size]))
            out = model(chunk.to(device), include_top=include_top)
            pools.append(out["pool"].cpu().numpy())
            if include_top:
                logits.append(out["logits"].cpu().numpy())
        pool = np.concatenate(pools, 0)
        return (pool, np.concatenate(logits, 0)) if include_top else pool

    return feature_fn


# -- Keras weight conversion (h5py imported on use) ----------------------------


def _fold_bn(kernel, beta, mean, var):
    """Fold inference BatchNorm (scale=False -> gamma=1) into conv weights:
    y = (conv(x) - mean) / sqrt(var+eps) + beta  ==  conv'(x) + bias'."""
    scale = 1.0 / np.sqrt(var + BN_EPS)
    return kernel * scale[None, None, None, :], beta - mean * scale


def _numbered(names, prefix):
    """Sort Keras auto-numbered layer names ('conv2d', 'conv2d_1', ...) by
    index; a bare name counts as index 0. Released h5 files start at _1."""
    out = []
    for n in names:
        if n == prefix:
            out.append((0, n))
        elif n.startswith(prefix + "_"):
            suffix = n[len(prefix) + 1:]
            if suffix.isdigit():
                out.append((int(suffix), n))
    return [n for _, n in sorted(out)]


def convert_keras_h5(h5_path: str) -> Params:
    """Convert a Keras InceptionV3 ``.h5`` weights file (the
    ``inception_v3_weights_tf_dim_ordering_tf_kernels[_notop].h5`` release
    layout, or Keras 3's ``.weights.h5``) into the folded parameter tree."""
    import h5py

    params: Params = {}
    with h5py.File(h5_path, "r") as f:
        if "layers" in f and "conv2d" in f["layers"]:
            return _convert_keras3_h5(f)
        root = f["model_weights"] if "model_weights" in f else f

        def leaf(group):
            # h5 layout: root[layer_name][layer_name][weight_name]
            sub = group
            keys = list(sub.keys())
            while len(keys) == 1 and not hasattr(sub[keys[0]], "shape"):
                sub = sub[keys[0]]
                keys = list(sub.keys())
            return sub

        convs = _numbered(root.keys(), "conv2d")
        bns = _numbered(root.keys(), "batch_normalization")
        if len(convs) != num_convs() or len(bns) != num_convs():
            raise ValueError(f"unexpected layer counts: {len(convs)} convs, {len(bns)} bns")
        for i, (cn, bn) in enumerate(zip(convs, bns)):
            cg, bg = leaf(root[cn]), leaf(root[bn])
            k, b = _fold_bn(np.asarray(cg["kernel:0"]), np.asarray(bg["beta:0"]),
                            np.asarray(bg["moving_mean:0"]),
                            np.asarray(bg["moving_variance:0"]))
            params[f"conv{i}"] = {"kernel": k, "bias": b}
        preds = _numbered(root.keys(), "predictions")
        if preds:
            pg = leaf(root[preds[0]])
            params["predictions"] = {"kernel": np.asarray(pg["kernel:0"]),
                                     "bias": np.asarray(pg["bias:0"])}
    return params


# Keras-3 `save_weights` names the h5 groups by *topological* position
# (model.layers order): _KERAS3_TOPO[i] = creation-order index of the i-th
# conv/BN group in the file (identical for convs and BNs).
_KERAS3_TOPO = [
    0, 1, 2, 3, 4, 8, 6, 9, 5, 7, 10, 11, 15, 13, 16, 12, 14, 17, 18, 22,
    20, 23, 19, 21, 24, 25, 27, 28, 26, 29, 34, 35, 31, 36, 32, 37, 30, 33,
    38, 39, 44, 45, 41, 46, 42, 47, 40, 43, 48, 49, 54, 55, 51, 56, 52, 57,
    50, 53, 58, 59, 64, 65, 61, 66, 62, 67, 60, 63, 68, 69, 72, 73, 70, 74,
    71, 75, 80, 77, 81, 78, 79, 82, 83, 76, 84, 89, 86, 90, 87, 88, 91, 92,
    85, 93,
]


def _convert_keras3_h5(f) -> Params:
    """Keras-3 ``model.save_weights('*.weights.h5')`` layout:
    ``layers/<topo_name>/vars/{0,1,2}`` — conv vars=[kernel]; BN with
    ``scale=False`` vars=[beta, moving_mean, moving_variance]; the top Dense
    is auto-named ``dense`` (or keeps ``predictions``)."""
    root = f["layers"]
    params: Params = {}
    convs = _numbered(root.keys(), "conv2d")
    bns = _numbered(root.keys(), "batch_normalization")
    if len(convs) != num_convs() or len(bns) != num_convs():
        raise ValueError(f"unexpected layer counts: {len(convs)} convs, {len(bns)} bns")
    for topo, (cn, bn) in enumerate(zip(convs, bns)):
        bv = root[bn]["vars"]
        k, b = _fold_bn(np.asarray(root[cn]["vars"]["0"]),
                        *(np.asarray(bv[k]) for k in ("0", "1", "2")))
        params[f"conv{_KERAS3_TOPO[topo]}"] = {"kernel": k, "bias": b}
    for dense_name in ("predictions", "dense"):
        if dense_name in root:
            dv = root[dense_name]["vars"]
            params["predictions"] = {"kernel": np.asarray(dv["0"]),
                                     "bias": np.asarray(dv["1"])}
            break
    return params
