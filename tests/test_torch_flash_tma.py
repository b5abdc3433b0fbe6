"""The wgmma + TMA attention core's host side, on the CPU: the TMA geometry
that ``_launch`` / ``_launch_bhld`` hand to the kernels for every view the
UNet passes (d-major qt / vt, a strided k, (B, H, L, D) views of packed
(B, L, 3, H, D) and (B, L, H*D) projections at kv 77 and 4096; the online
mode's kv tile at 9216 rows; the cross-attention mode at kv 77; a kv
tail), each with the kv tile the library picks for it, its refusal of views
the TMA cannot read, and the plain version the card holds the d-major kernel
to: ``_plain_1block(sum="bf16")`` on the transposed d-major
inputs against JAX ``flash_mha_eod`` with the pvtd Pallas kernel in
interpret mode, within one bf16 ulp of the largest output (both round q,
p and the output to bf16 at the same places; only fp32 summation order
differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from superdiff_tpu.ops.pallas import flash_attention as jfa
from superdiff_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

BF = torch.bfloat16


def _maps(geom):
    n = fa._GEOM_LEN
    assert len(geom) == 4 * n
    return [dict(dims=geom[i:i + 4], strides=geom[i + 4:i + 7], box=geom[i + 7:i + 9],
                 swizzle=geom[i + 9]) for i in range(0, 4 * n, n)]


@pytest.mark.parametrize("d,l", [(40, 4096), (80, 1024), (160, 256)])
def test_dmajor_geometry_with_a_strided_k(d, l):
    b, h = 2, 8
    qt = torch.empty(b, h, d, l, dtype=BF)
    vt = torch.empty(b, h, d, l, dtype=BF)
    # k as the UNet hands it over: a (B, H, L, D) view of a (B, L, H, D) projection
    k = torch.empty(b, l, h, d, dtype=BF).permute(0, 2, 1, 3)
    out = torch.empty(b, h, d, l, dtype=BF)
    bk = 64  # attn_eod_tile
    q_, k_, v_, o_ = _maps(fa._tma_geometry("eod", qt, k, vt, out, dmajor=True, bk=bk))
    dp = -(-d // 16) * 16
    assert q_ == dict(dims=(l, d, h, b), strides=(2 * l, 2 * d * l, 2 * h * d * l),
                      box=(64, dp), swizzle=128)
    assert k_ == dict(dims=(d, l, h, b), strides=(2 * h * d, 2 * d, 2 * l * h * d),
                      box=(64, bk), swizzle=128)
    assert v_ == dict(dims=(l, d, h, b), strides=q_["strides"], box=(64, d), swizzle=128)
    assert o_ == dict(dims=(l, d, h, b), strides=q_["strides"], box=(64, d), swizzle=0)


@pytest.mark.parametrize("d,l", [(40, 4096), (40, 77), (160, 77), (80, 4096)])
def test_bhld_geometry_of_a_packed_qkv_projection(d, l):
    b, h = 2, 8
    qkv = torch.empty(b, l, 3, h, d, dtype=BF)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    out = torch.empty(b, l, h, d, dtype=BF).transpose(1, 2)  # written packed
    # the library's tile: one 80-row kv tile for a short row at D <= 80, else 64 rows
    bk = 80 if d <= 80 and l <= 80 else 64
    maps = _maps(fa._tma_geometry("bhld", q, k, v, out, dmajor=False, bk=bk))
    row, head, batch = 2 * 3 * h * d, 2 * d, 2 * l * 3 * h * d
    for m in maps[:3]:
        assert m["dims"] == (d, l, h, b) and m["strides"] == (row, head, batch)
        assert m["swizzle"] == 128
    assert maps[0]["box"] == (64, 64)
    assert maps[1]["box"] == maps[2]["box"] == (64, bk)
    assert maps[3] == dict(dims=(d, l, h, b), strides=(2 * h * d, 2 * d, 2 * l * h * d),
                           box=(d, 64), swizzle=0)


@pytest.mark.parametrize("lk", [77, 4096])
def test_bhld_geometry_of_packed_cross_projections(lk):
    """The text cross-attention: q (B, Lq, H*D), k and v (B, 77, H*D)."""
    b, h, d, lq = 2, 8, 40, 4096
    q = torch.empty(b, lq, h * d, dtype=BF).view(b, lq, h, d).transpose(1, 2)
    k, v = (torch.empty(b, lk, h * d, dtype=BF).view(b, lk, h, d).transpose(1, 2)
            for _ in range(2))
    out = torch.empty(b, h, lq, d, dtype=BF)
    q_, k_, v_, o_ = _maps(fa._tma_geometry("cross", q, k, v, out, dmajor=False,
                                            bk=80 if lk <= 80 else 64))
    assert q_["dims"] == (d, lq, h, b) and q_["strides"] == (2 * h * d, 2 * d, 2 * lq * h * d)
    assert k_["dims"] == v_["dims"] == (d, lk, h, b)
    assert k_["strides"] == (2 * h * d, 2 * d, 2 * lk * h * d)
    assert o_["dims"] == (d, lq, h, b) and o_["strides"] == (2 * d, 2 * lq * d, 2 * h * lq * d)


@pytest.mark.parametrize("d,bk", [(40, 128), (80, 128), (160, 64)])
def test_online_geometry_of_a_packed_qkv_projection(d, bk):
    """``_kernel`` (mode 2) on (B, H, L, D) views of one packed projection at
    the 768 px level-0 length: the online body's kv tile, 128 rows at
    D <= 80."""
    b, h, l = 2, 8, 9216
    qkv = torch.empty(b, l, 3, h, d, dtype=BF)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    out = torch.empty(b, h, l, d, dtype=BF)
    maps = _maps(fa._tma_geometry("online", q, k, v, out, dmajor=False, bk=bk))
    for m in maps[:3]:
        assert m["dims"] == (d, l, h, b) and m["strides"] == (2 * 3 * h * d, 2 * d, 2 * l * 3 * h * d)
    assert maps[0]["box"] == (64, 64)
    assert maps[1]["box"] == maps[2]["box"] == (64, bk)
    assert maps[3] == dict(dims=(d, l, h, b), strides=(2 * d, 2 * l * d, 2 * h * l * d),
                           box=(d, 64), swizzle=0)


@pytest.mark.parametrize("d,bk", [(40, 80), (160, 64)])
def test_cross_packed_geometry_at_kv_77(d, bk):
    """``_kernel_cross_packed`` (mode 3): q (B, Lq, H*D), k and v (B, 77,
    H*D), the output written packed; one 80-row kv tile at D = 40 (the
    persistent short body), 64-row tiles at D = 160 (two-pass, two tiles)."""
    b, h, lq, lk = 2, 8, 4096, 77
    q = torch.empty(b, lq, h * d, dtype=BF).view(b, lq, h, d).transpose(1, 2)
    k, v = (torch.empty(b, lk, h * d, dtype=BF).view(b, lk, h, d).transpose(1, 2)
            for _ in range(2))
    out = torch.empty(b, lq, h * d, dtype=BF).view(b, lq, h, d).transpose(1, 2)
    q_, k_, v_, o_ = _maps(fa._tma_geometry("cross", q, k, v, out, dmajor=False, bk=bk))
    assert k_["dims"] == v_["dims"] == (d, lk, h, b)
    assert k_["box"] == v_["box"] == (64, bk)
    assert k_["strides"] == (2 * h * d, 2 * d, 2 * lk * h * d)
    assert q_["dims"] == o_["dims"] == (d, lq, h, b)
    assert o_["strides"] == q_["strides"] == (2 * h * d, 2 * d, 2 * lq * h * d)
    assert o_["box"] == (d, 64) and o_["swizzle"] == 0


@pytest.mark.parametrize("online,lk", [(True, 1000), (True, 4600), (False, 77), (False, 1000)])
def test_kv_tail_that_is_not_a_multiple_of_the_tile(online, lk):
    """The tensor map spans exactly lk rows: the last tile's rows past lk are
    the TMA's zero fill (the kernel sets their scores to -inf), never memory
    past the view, even where the packed projection goes on."""
    b, h, d, lq = 1, 2, 40, 256
    kv = torch.empty(b, lk + 64, 2, h, d, dtype=BF)[:, :lk]
    k, v = (kv[:, :, i].permute(0, 2, 1, 3) for i in range(2))
    q = torch.empty(b, h, lq, d, dtype=BF)
    # the library's tiles: 128 rows online, 80 for a short row, else 64
    bk = 128 if online else 80 if lk <= 80 else 64
    _, k_, v_, _ = _maps(fa._tma_geometry("tail", q, k, v, q, dmajor=False, bk=bk))
    assert lk % bk
    assert k_["dims"][1] == v_["dims"][1] == lk
    assert k_["box"] == (64, bk)


def test_geometry_table_is_passed_as_a_c_array():
    b, h, l, d = 2, 8, 77, 40
    qkv = torch.empty(b, l, 3, h, d, dtype=BF)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    out = torch.empty(b, h, l, d, dtype=BF)
    geom = fa._tma_geometry("arg", q, k, v, out, dmajor=False, bk=80)
    arg = fa._geometry_arg(geom)
    assert len(arg) == 4 * fa._GEOM_LEN and list(arg) == list(geom)
    # another view of the same memory: another table
    other = fa._tma_geometry("arg", q, k, v, out.transpose(1, 2).contiguous().transpose(1, 2),
                             dmajor=False, bk=80)
    assert other != geom


def test_size_one_dims_take_any_stride():
    q = torch.empty(1, 1, 130, 40, dtype=BF)
    geom = fa._tma_map("one", q.as_strided(q.shape, (3, 5, 40, 1)), (64, 64), 128)
    assert geom[4:7] == (80, 16, 16)


def test_geometry_raises_where_the_tma_cannot_read():
    b, l, h, d = 2, 77, 8, 40
    # a row stride of 3*H*D + 4 elements: 1928 bytes, not a multiple of 16
    wide = torch.empty(b, l, 3 * h * d + 4, dtype=BF)
    q = wide[..., :3 * h * d].view(b, l, 3, h, d)[:, :, 0].permute(0, 2, 1, 3)
    ok = torch.empty(b, h, l, d, dtype=BF)
    with pytest.raises(ValueError, match="multiples of 16"):
        fa._tma_geometry("x", q, ok, ok, ok, dmajor=False, bk=80)
    # a base 8 bytes past a 16-byte boundary
    flat = torch.empty(b * h * l * d + 8, dtype=BF)
    start = (-(flat.data_ptr() // 2) % 8) + 4
    shifted = flat[start:start + b * h * l * d].view(b, h, l, d)
    assert shifted.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._tma_geometry("x", ok, shifted, ok, ok, dmajor=False, bk=80)
    with pytest.raises(ValueError, match="unit stride"):
        fa._tma_map("x", ok.transpose(2, 3), (64, 64), 128)


def test_cuda_launch_raises_on_cpu_tensors_before_any_geometry():
    qt = torch.zeros(1, 1, 40, 256, dtype=BF)
    with pytest.raises(ValueError, match="CUDA"):
        fa._launch(qt, qt.transpose(2, 3), qt, 40**-0.5)


@pytest.mark.parametrize("d", [40, 64, 80])
def test_bf16_sum_plain_version_matches_pvtd_interpret_within_one_ulp(d):
    """The plain version phase 2 of chip_smoke.py holds the d-major kernel
    to, against the pvtd Pallas kernel it replaces (L = 512: pvtd1)."""
    rng = np.random.default_rng(50 + d)
    b, h, l = 2, 2, 512
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, h, d, l), (b, h, l, d), (b, h, d, l))]
    ref = np.asarray(jfa.flash_mha_eod(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                                       interpret=True).astype(jnp.float32))
    qt, k, vt = (t(a).to(BF) for a in arrays)
    got = fa._plain_1block(qt.transpose(2, 3), k, vt.transpose(2, 3), d**-0.5,
                           "bf16").transpose(2, 3).float().numpy()
    # one bf16 ulp at the largest output: 2^(exponent - 7)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(got - ref).max() <= ulp
