"""The precision the plain references compute their products in.

Every matrix product and convolution of a reference takes its two inputs
through :func:`q` first and then runs in float32 with TF32 off, so the
reference is float32 (``fp32``: ``q`` is the identity) or emulates a lower
precision of the inputs with a float32 accumulator, as tensor cores do:
``bf16`` rounds each input to bfloat16, ``fp8`` scales each tensor by its
absolute maximum onto float8 e4m3's range (448) and rounds it there, the
usual per-tensor scaling of fp8 inference. Norms, softmaxes and the
sampler's arithmetic stay float32 in every mode.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("fp32", "bf16", "fp8")
_E4M3_MAX = 448.0
_mode = ["fp32"]


def mode() -> str:
    return _mode[0]


@contextlib.contextmanager
def precision(name: str):
    """Compute the references' products in ``name`` (one of :data:`MODES`),
    float32 with TF32 off, inside the block; cuDNN picks its fastest
    float32 algorithms there."""
    if name not in MODES:
        raise ValueError(f"precision {name!r}; one of {MODES}")
    b = torch.backends
    saved = (_mode[0], b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark)
    _mode[0] = name
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.benchmark = True  # the fastest float32 convolutions for the reference's shapes
    try:
        yield
    finally:
        _mode[0], b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark = saved


def q(x: torch.Tensor) -> torch.Tensor:
    """One input of a product, float32, rounded as the mode says."""
    x = x.float()
    m = _mode[0]
    if m == "fp32":
        return x
    if m == "bf16":
        return x.to(torch.bfloat16).float()
    scale = x.abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
