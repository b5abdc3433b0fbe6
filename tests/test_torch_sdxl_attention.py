"""SDXL's attention at head dim 64 on the CPU: the rows its UNet hands over
take the d-major route (``flash_mha_eod``, the kernel's plain version
here) wherever SD-1.x's long rows do; the route's plain version against
the fp32 reference, its tangents through ``_reference_eod``; the TMA
geometry the card's launch would encode at D = 64; the 77-token
cross-attention keeps its plain path.

Tolerances: the plain version rounds q, p and the output to bf16 as the
kernel does, so against the fp32 reference on bf16 inputs it keeps within
2e-2 of the largest output (the card's phase-2 tolerance); fp32 inputs
agree to 1e-5 (the plain version rounds nothing then but the summation
order differs); the tangents are the reference's own, so they agree to
1e-6.
"""

import pytest
import torch

import superdiff_tpu_torch.models.sd.unet as U
from superdiff_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

BF = torch.bfloat16


def _dmajor(b, h, l, d=64, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    qt = torch.randn(b, h, d, l, generator=g).to(dtype)
    k = torch.randn(b, l, h, d, generator=g).to(dtype).permute(0, 2, 1, 3)
    vt = torch.randn(b, h, d, l, generator=g).to(dtype)
    return qt, k, vt


@pytest.mark.parametrize("l", [512, 1024])
def test_d64_takes_the_dmajor_route(monkeypatch, l):
    taken = []
    real = fa._FlashEod.apply
    monkeypatch.setattr(fa._FlashEod, "apply", lambda *a: taken.append(a[0].shape) or real(*a))
    qt, k, vt = _dmajor(1, 2, l)
    out = fa.flash_mha_eod(qt, k, vt)
    assert taken == [(1, 2, 64, l)]
    want = fa._reference_eod(qt, k, vt, 64**-0.5)
    assert (out - want).abs().max() <= 1e-5 * want.abs().max()


def test_d64_plain_version_rounds_as_the_kernel():
    qt, k, vt = _dmajor(2, 2, 512, dtype=BF, seed=1)
    out = fa.flash_mha_eod(qt, k, vt)
    assert out.dtype == BF
    want = fa._reference_eod(qt.float(), k.float(), vt.float(), 64**-0.5)
    assert (out.float() - want).abs().max() <= 2e-2 * want.abs().max()


def test_d64_tangents_go_through_the_reference():
    qt, k, vt = _dmajor(1, 2, 512, seed=2)
    tans = _dmajor(1, 2, 512, seed=3)
    _, got = torch.func.jvp(lambda a, b, c: fa.flash_mha_eod(a, b, c), (qt, k, vt), tans)
    _, want = torch.func.jvp(lambda a, b, c: fa._reference_eod(a, b, c, 64**-0.5),
                             (qt, k, vt), tans)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("l", [4096, 1024])
def test_d64_tma_geometry(l):
    """The boxes the D = 64 instance checks: q and v (64 tokens, 64 d
    rows), k (64 d columns, 64 kv rows), all 128-byte swizzled; the output
    stored unswizzled."""
    b, h, d = 12, 10 if l == 4096 else 20, 64
    qt = torch.empty(b, h, d, l, dtype=BF)
    k = torch.empty(b, l, h, d, dtype=BF).permute(0, 2, 1, 3)
    geom = fa._tma_geometry("eod", qt, k, qt, torch.empty_like(qt), dmajor=True, bk=64)
    n = fa._GEOM_LEN
    boxes = [(geom[i + 7], geom[i + 8], geom[i + 9]) for i in range(0, 4 * n, n)]
    assert boxes == [(64, 64, 128), (64, 64, 128), (64, 64, 128), (64, 64, 0)]
    assert geom[n:n + 4] == (d, l, h, b)


def test_sdxl_attention_rows_route(monkeypatch):
    """A head-dim-64 self-attention over 1024 tokens reaches
    ``flash_mha_eod``; the 77-token cross-attention at 2048 context
    width stays on the plain path."""
    seen = []
    real = U.flash_mha_eod
    monkeypatch.setattr(U, "flash_mha_eod", lambda qt, k, vt: seen.append(qt.shape)
                        or real(qt, k, vt))
    blk = U.TransformerBlock(128, 2, 2048, dtype=torch.float32, ffn_impl="einsum")
    with torch.no_grad():
        blk(torch.randn(2, 1024, 128), torch.randn(2, 77, 2048))
    assert seen == [(2, 2, 64, 1024)]
