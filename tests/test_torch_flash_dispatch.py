"""The port's attention dispatch against the JAX package's: for each of the
three entries (``flash_mha``, ``flash_mha_bhld``, ``flash_mha_eod``) and a
table of shapes and levers, both packages must pick the same TPU kernel (or
the plain version).

Nothing is computed: on the JAX side the entry is traced with
``jax.eval_shape`` while ``pl.pallas_call`` is replaced by a spy that records
the kernel body's name; on the port's side the plain versions that a CPU
tensor is handed to are replaced by spies that record the kernel name the
dispatch chose.
"""

import functools
import re

import jax
import jax.numpy as jnp
import pytest
import torch

from superdiff_tpu.ops.pallas import flash_attention as jfa
from superdiff_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

# (lq, lk, head_dim, keyword arguments): the SD rows at 512, 768 and 1024 px
# (4096/40, 1024/80, 9216/40, 2304/80, 576/160, 16384/40, 1024/160), the
# 77-token cross-attention, the short self-attention rows, a caller's block_k
# above and below the 1024-token rule, and rows that do not tile
SHAPES = [
    (4096, 4096, 40, {}), (1024, 1024, 80, {}), (9216, 9216, 40, {}), (2304, 2304, 80, {}),
    (576, 576, 160, {}), (16384, 16384, 40, {}), (1024, 1024, 160, {}), (4608, 4608, 40, {}),
    (4096, 77, 40, {}), (256, 256, 160, {}), (64, 64, 160, {}), (320, 320, 80, {}),
    (2048, 2048, 40, {"block_k": 512}), (1024, 1024, 80, {"block_k": 256}),
    (2048, 2048, 40, {"block_q": 128, "block_k": 1024}), (4100, 4100, 40, {}),
    (2048, 1100, 40, {}),
]
ENTRIES = ["flash_mha", "flash_mha_bhld", "flash_mha_eod"]


def _table_name(body: str) -> str:
    """The TPU kernel a Pallas body belongs to (pipe2/pipe4, pvt1/2/4 and
    pvtd1/2 are bodies of one factory each)."""
    m = re.fullmatch(r"_kernel_1block_(pipe|pvtd|pvt)\d", body)
    return f"_make_{m.group(1)}_kernel" if m else body


def _arrays(entry, lq, lk, d, make, h=1):
    if entry == "flash_mha":
        return make(1, lq, h, d), make(1, lk, h, d), make(1, lk, h, d)
    if entry == "flash_mha_bhld":
        return make(1, h, lq, d), make(1, h, lk, d), make(1, h, lk, d)
    return make(1, h, d, lq), make(1, h, lk, d), make(1, h, d, lk)


def _jax_choice(monkeypatch, entry, lq, lk, d, kwargs, h=1):
    seen = []

    def spy(kernel, out_shape, **_):
        body = kernel.func if isinstance(kernel, functools.partial) else kernel
        seen.append(_table_name(body.__name__))
        return lambda *a: jnp.zeros(out_shape.shape, out_shape.dtype)

    monkeypatch.setattr(jfa.pl, "pallas_call", spy)
    args = _arrays(entry, lq, lk, d, lambda *s: jax.ShapeDtypeStruct(s, jnp.float32), h)
    jax.eval_shape(lambda *a: getattr(jfa, entry)(*a, interpret=True, **kwargs), *args)
    assert len(seen) <= 1
    return seen[0] if seen else "plain"


def _port_choice(monkeypatch, entry, lq, lk, d, kwargs, h=1):
    seen = []

    def plain_spy(name, q, *_):
        seen.append(name)
        return torch.zeros_like(q)

    def reference_spy(name):
        def spy(q, *_):
            seen.append(name)
            return torch.zeros_like(q)
        return spy

    monkeypatch.setattr(fa, "_plain", plain_spy)
    monkeypatch.setattr(fa, "_reference", reference_spy("plain"))
    monkeypatch.setattr(fa, "_reference_bhld", reference_spy("plain"))
    monkeypatch.setattr(fa, "_reference_eod", reference_spy("_make_pvtd_kernel"))
    getattr(fa, entry)(*_arrays(entry, lq, lk, d, torch.zeros, h), **kwargs)
    assert len(seen) == 1
    return seen[0]


def _both(monkeypatch, entry, lq, lk, d, kwargs, h=1):
    if entry == "flash_mha_eod":  # it takes no block_k
        kwargs = {k: v for k, v in kwargs.items() if k != "block_k"}
    return (_port_choice(monkeypatch, entry, lq, lk, d, kwargs, h),
            _jax_choice(monkeypatch, entry, lq, lk, d, kwargs, h))


# flash_mha_eod is self-attention only
CASES = [(e, *s) for e in ENTRIES for s in SHAPES if e != "flash_mha_eod" or s[0] == s[1]]


@pytest.mark.parametrize("entry,lq,lk,d,kwargs", CASES,
                         ids=[f"{e}-{a}x{b}d{c}{'b' if k else ''}" for e, a, b, c, k in CASES])
def test_same_kernel_as_jax(monkeypatch, entry, lq, lk, d, kwargs):
    port, ref = _both(monkeypatch, entry, lq, lk, d, kwargs)
    assert port == ref, (entry, lq, lk, d, kwargs)


@pytest.mark.parametrize("entry", ["flash_mha", "flash_mha_bhld"])
@pytest.mark.parametrize("impl", sorted(fa._LONG_KERNELS))
def test_long_impl_lever_picks_the_same_kernel(monkeypatch, entry, impl):
    assert sorted(fa._LONG_KERNELS) == sorted(jfa._LONG_KERNELS)
    monkeypatch.setattr(fa, "_LONG_IMPL", impl)
    monkeypatch.setattr(jfa, "_LONG_IMPL", impl)
    for l in (4096, 2048):
        port, ref = _both(monkeypatch, entry, l, l, 40, {})
        assert port == ref == fa._LONG_KERNELS[impl][0]


def test_mh_max_kv_lever(monkeypatch):
    monkeypatch.setattr(fa, "_MH_MAX_KV", 512)
    monkeypatch.setattr(jfa, "_MH_MAX_KV", 512)
    port, ref = _both(monkeypatch, "flash_mha_bhld", 1024, 1024, 80, {})
    assert port == ref == "_make_pvt_kernel"
    port, ref = _both(monkeypatch, "flash_mha_bhld", 512, 512, 80, {})
    assert port == ref == "_kernel_mh"


def test_the_main_path_rows_reach_the_kernels_the_table_names(monkeypatch):
    """The 768 px rows through ``flash_mha_eod``: three dispatch rules in a
    row (not a multiple of 128 -> bhld -> block_q 64 -> ``_kernel_mh``)."""
    want = {(9216, 40): "_kernel", (2304, 80): "_make_pvtd_kernel", (576, 160): "_kernel_mh",
            (4096, 40): "_make_pvtd_kernel", (1024, 80): "_make_pvtd_kernel"}
    for (l, d), name in want.items():
        assert _port_choice(monkeypatch, "flash_mha_eod", l, l, d, {}) == name
    assert fa._blocks(576, 576, None, None) == (64, 576)
    assert fa._blocks(9216, 9216, None, None) == (1024, 1024)
    assert fa._blocks(4608, 4608, None, None) == (512, 512)


def _set_lever(monkeypatch, lever, kwargs):
    """Select a packed-layout lever in both packages; returns the keyword
    arguments of ``flash_mha`` under it."""
    if lever in ("native_long_kv", "flash_nat"):
        return {**kwargs, "native_long_kv": True}
    monkeypatch.setattr(fa, "_CROSS_IMPL", lever)
    monkeypatch.setattr(jfa, "_CROSS_IMPL", lever)
    return kwargs


@pytest.mark.parametrize("lever", ["native_long_kv", "nat", "xpk"])
@pytest.mark.parametrize("lq,lk,d,kwargs", SHAPES,
                         ids=[f"{a}x{b}d{c}{'b' if k else ''}" for a, b, c, k in SHAPES])
def test_packed_layout_levers_pick_the_same_kernel(monkeypatch, lever, lq, lk, d, kwargs):
    port, ref = _both(monkeypatch, "flash_mha", lq, lk, d, _set_lever(monkeypatch, lever, kwargs))
    assert port == ref, (lever, lq, lk, d, kwargs)


# per SD step (latent batch 8, 8 heads): (tokens, head dim, transformer
# blocks at that level); each block has a self- and a 77-token cross-row
SD_ROWS = {512: [(4096, 40, 5), (1024, 80, 5), (256, 160, 5), (64, 160, 1)],
           768: [(9216, 40, 5), (2304, 80, 5), (576, 160, 5), (144, 160, 1)]}


@pytest.mark.parametrize("px,lever,want", [
    (512, "flash_nat", {"_kernel_mh_nat": 32}),
    (512, "xpk", {"_kernel_cross_packed": 5, "_kernel_mh_nat": 17}),
    (512, "nat", {"_kernel_mh_nat": 22}),
    (768, "flash_nat", {"_kernel": 5, "_kernel_mh_nat": 27}),
])
def test_sd_step_kernels_under_the_levers(monkeypatch, px, lever, want):
    """The kernels one SD step reaches through ``flash_mha`` under each lever,
    in both packages: ``attn_impl="flash_nat"`` sends every row there with
    ``native_long_kv``; under the ``_CROSS_IMPL`` levers the default
    ``flash_eod`` keeps the long self-attention rows (10 ``flash_mha_eod``
    launches) and the other 22 rows go through ``flash_mha``."""
    tally = {}
    for l, d, blocks in SD_ROWS[px]:
        for lk in (l, 77):
            if lever != "flash_nat" and lk == l > 256:
                continue  # flash_mha_eod's rows
            kwargs = _set_lever(monkeypatch, lever, {})
            port, ref = _both(monkeypatch, "flash_mha", l, lk, d, kwargs, h=8)
            assert port == ref, (l, lk, d)
            tally[port] = tally.get(port, 0) + blocks
    assert tally == want
