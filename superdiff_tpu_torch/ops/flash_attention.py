"""Softmax attention for the SD UNet: the three entry points of
``superdiff_tpu/ops/pallas/flash_attention.py`` and their dispatch.

* :func:`flash_mha` on (B, L, H, D), the UNet's native layout;
* :func:`flash_mha_bhld` on (B, H, L, D), the ``flash_eo`` entry;
* :func:`flash_mha_eod` with q, v and the output in the d-major (B, H, D, L)
  layout and k in (B, H, L, D), the ``flash_eod`` entry.

Which kernel a shape reaches is decided as in the JAX package, block-size
rules included (``block_k`` is the whole row up to 1024 kv tokens, else
``min(4096, lk)`` halved until it divides; ``block_q`` halved until it
divides), and is named after the TPU kernel it replaces:

==========================  ===============================================
``native_long_kv=True``,    ``_kernel_mh_nat`` (packed layout) when the q
one kv block                block (``min(64, block_q)`` above 256 kv) halves
                            to at least 8
kv <= 256                   ``_CROSS_IMPL``: ``einsum`` plain PyTorch
                            (:func:`_reference`), as in JAX; ``xpk``
                            ``_kernel_cross_packed`` for kv <= 128 and
                            lq >= 4 * H * 128, else ``_kernel_mh_nat``;
                            ``nat`` ``_kernel_mh_nat``
one kv block, kv <= 1024    ``_kernel_mh``
one kv block, kv > 1024     ``_LONG_IMPL``: ``1block`` -> ``_kernel_1block``,
                            ``mxsum`` -> ``_kernel_1block_mxsum``, ``pipe2/4``
                            -> ``_make_pipe_kernel``, ``pvt1/2/4`` ->
                            ``_make_pvt_kernel``
several kv blocks           ``_kernel`` (online softmax)
``flash_mha_eod``           ``_make_pvtd_kernel`` for 256 < kv <= 4096 when
                            the q block is a multiple of 128 per chain, else
                            it hands over to ``flash_mha_bhld``
==========================  ===============================================

The Hopper kernels are ``csrc/flash_attention.cu`` (d-major) and
``csrc/flash_attention_bhld.cu`` (one kernel in four modes: single block
with the row sum of the fp32 p, single block with the row sum of the bf16 p,
online softmax, and the short-kv mode of ``_kernel_cross_packed``). All of
them run on one ``wgmma`` + TMA core, ``csrc/attn_sm90.cuh``, which reads
every operand through a tensor map; :func:`_tma_geometry` computes the maps'
geometry (and raises where the TMA cannot read a view) with the kv tile the
library picks (:func:`_kv_tile`); the library encodes the maps, memoised on
every encode argument (:func:`map_cache_stats` counts its hits). The
packed-layout kernels (``_kernel_mh_nat``, ``_kernel_cross_packed``) take
(B, H, L, D) views of the packed (B, L, H*D) projections and write their
output packed: no layout copy. A CUDA tensor is launched or raises (bf16,
head dims 40 / 80 / 160, rows 16-byte aligned with unit stride along D; the
d-major kernel takes L a multiple of 64, the (B, H, L, D) kernel any kv, up
to 128 in the ``_kernel_cross_packed`` mode); a CPU tensor takes the
kernel's plain PyTorch version, which rounds where the TPU body rounds.
Forward-mode derivatives go through :func:`_reference` /
:func:`_reference_bhld` / :func:`_reference_eod`, as the JAX ``custom_jvp``
rules do.

Launches are counted per TPU-kernel name: ``flash_mha_bhld.launches`` (a
dict, shared with ``flash_mha``) and ``flash_mha_eod.launches`` (the d-major
kernel, ``_make_pvtd_kernel``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LOG2_E = 1.4426950408889634
_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "attn_eod_supports": (_ci, [_ci]),
    "attn_eod_tile": (_ci, []),
    "attn_eod_launch": (_ci, [_vp] * 4 + [_ci] * 4 + [_vp, _cf, _vp]),
    "attn_eod_map_cache_stats": (None, [_vp]),
}
_SIGNATURES_BHLD = {
    "attn_bhld_supports": (_ci, [_ci]),
    "attn_bhld_body": (_ci, [_ci] * 3),
    "attn_bhld_tile": (_ci, [_ci] * 3),
    "attn_bhld_launch": (_ci, [_vp] * 4 + [_ci] * 5 + [_vp, _cf, _ci, _vp]),
    "attn_bhld_map_cache_stats": (None, [_vp]),
}

# Module-level levers, as in the JAX module (its tests and sweeps select
# kernels through them).
_LONG_IMPL = "pvt1"    # single-kv-block kernel for kv > _MH_MAX_KV
_LONG_BLOCK_Q = 2048   # q block of the long rows
_MH_MAX_KV = 1024      # kv ceiling of _kernel_mh
_CROSS_IMPL = "einsum"  # kv <= 256: "einsum" plain attention, "nat", "xpk"
_EOD_CHAINS_LONG, _EOD_BLOCK_Q = 2, 4096     # pvtd2 for kv > 1024
_EOD_CHAINS_MID, _EOD_BLOCK_Q_MID = 1, 2048  # pvtd1 for kv <= 1024

# _LONG_IMPL -> (TPU kernel, where its row sum comes from)
_LONG_KERNELS = {
    "1block": ("_kernel_1block", "fp32"),
    "mxsum": ("_kernel_1block_mxsum", "bf16"),
    "pipe2": ("_make_pipe_kernel", "bf16"),
    "pipe4": ("_make_pipe_kernel", "bf16"),
    "pvt1": ("_make_pvt_kernel", "bf16"),
    "pvt2": ("_make_pvt_kernel", "bf16"),
    "pvt4": ("_make_pvt_kernel", "bf16"),
}
_SUM_OF = {"_kernel_mh": "fp32", "_kernel_mh_nat": "fp32", "_make_pvtd_kernel": "bf16",
           **dict(_LONG_KERNELS.values())}
# TPU kernel -> mode of flash_attention_bhld.cu (pvtd, d-major, has its own kernel)
_MODE_OF = {"_kernel": 2, "_kernel_cross_packed": 3,
            **{name: 0 if s == "fp32" else 1 for name, s in _SUM_OF.items()
               if name != "_make_pvtd_kernel"}}
_CROSS_MAX_KV = 128  # the kv block of _kernel_cross_packed


# --- plain PyTorch versions --------------------------------------------------

def _reference(q, k, v, sm_scale: float):
    """Plain attention, (B, L, H, D) layout, fp32 softmax."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def _reference_bhld(q, k, v, sm_scale: float):
    """Plain attention staying in (B, H, L, D)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


def _reference_eod(qt, k, vt, sm_scale: float):
    """Plain attention in the d-major layout: qt/vt/out (B, H, D, L),
    k (B, H, L, D); fp32 logits and softmax, probabilities cast to v's dtype."""
    logits = torch.einsum("bhdq,bhkd->bhqk", qt, k).float() * sm_scale
    attn = torch.softmax(logits, dim=-1).to(vt.dtype)
    return torch.einsum("bhqk,bhdk->bhdq", attn, vt)


def _scores(q, k, sm_scale):
    """Base-2 logits as the kernels form them: q scaled by
    ``sm_scale * log2 e`` in its own dtype, products accumulated in fp32."""
    qs = q * torch.tensor(sm_scale * LOG2_E, dtype=q.dtype, device=q.device)
    return qs.float() @ k.float().transpose(-1, -2)


def _plain_1block(q, k, v, sm_scale: float, sum: str = "fp32"):
    """Single-kv-block attention on (B, H, L, D), step by step as the TPU
    bodies: p = exp2(s - row max); ``sum="fp32"`` adds p before it is cast
    to v's dtype (``_kernel_1block``, ``_kernel_mh``), ``sum="bf16"`` after
    (``mxsum``, ``pipe``, ``pvt``, and pvtd on transposed d-major views);
    P.V from the cast p, fp32 accumulation, one divide."""
    s = _scores(q, k, sm_scale)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    pc = p.to(v.dtype)
    l = (p if sum == "fp32" else pc.float()).sum(-1, keepdim=True)
    return ((pc.float() @ v.float()) / l).to(q.dtype)


def _plain_cross_packed(q, k, v, sm_scale: float):
    """``_kernel_cross_packed`` on (B, H, L, D), kv <= 128, as its TPU body
    rounds: the zero-padded kv columns of its block-diagonal K give logits
    of exactly 0 that join the row max, so below 128 kv the shift is
    max(row max, 0); p is rounded to v's dtype and summed after the rounding;
    the row sum is rounded to k's dtype before it divides."""
    s = _scores(q, k, sm_scale)
    m = s.amax(-1, keepdim=True)
    if k.shape[2] < _CROSS_MAX_KV:
        m = m.clamp(min=0.0)
    pc = torch.exp2(s - m).to(v.dtype).float()
    l = pc.sum(-1, keepdim=True).to(k.dtype).float()
    return ((pc @ v.float()) / l).to(q.dtype)


def _plain_multiblock(q, k, v, sm_scale: float, block_q: int, block_k: int):
    """Online-softmax attention on (B, H, L, D), following ``_kernel``'s loop
    over kv blocks of ``block_k``: running max m, sum l of the fp32 p and
    fp32 acc, both rescaled by ``exp2(m_prev - m_next)``; p cast to v's dtype
    for P.V. (``block_q`` only cuts the rows into independent programs.)
    With ``block_k`` the card's kv tile (:func:`_kv_tile` of ``_kernel``)
    it rounds as the Hopper kernel does, step for step."""
    lk = k.shape[2]
    outs = []
    for qb in q.split(block_q, dim=2):
        m = torch.full(qb.shape[:3] + (1,), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        for j in range(0, lk, block_k):
            s = _scores(qb, k[:, :, j:j + block_k], sm_scale)
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_next)
            p = torch.exp2(s - m_next)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).float() @ v[:, :, j:j + block_k].float()
            m = m_next
        outs.append((acc / l).to(q.dtype))
    return torch.cat(outs, dim=2)


def _plain(name, q, k, v, sm_scale, block_q, block_k):
    """The plain version of the kernel called ``name``."""
    if name == "_kernel":
        return _plain_multiblock(q, k, v, sm_scale, block_q, block_k)
    if name == "_kernel_cross_packed":
        return _plain_cross_packed(q, k, v, sm_scale)
    return _plain_1block(q, k, v, sm_scale, _SUM_OF[name])


# --- dispatch ----------------------------------------------------------------

def _blocks(lq: int, lk: int, block_q, block_k):
    """The q and kv block sizes the JAX entries settle on."""
    block_q = block_q or min(_LONG_BLOCK_Q if lk > 1024 else 512, lq)
    # kv <= 1024: the whole row is the kv block, whatever the caller asked
    block_k = lk if lk <= 1024 else (block_k or min(4096, lk))
    while lq % block_q:
        block_q //= 2
    while lk % block_k:
        block_k //= 2
    return block_q, block_k


def _tiles(block_q: int, block_k: int, lk: int) -> bool:
    """False where the JAX entries give the sequence to the plain version."""
    return block_q >= 8 and (block_k >= 128 or block_k == lk)


def _kernel_name(lk: int, block_k: int) -> str:
    """The TPU kernel ``_flash_impl`` picks for these kv blocks."""
    if lk // block_k > 1:
        return "_kernel"
    if lk <= _MH_MAX_KV:
        return "_kernel_mh"
    return _LONG_KERNELS[_LONG_IMPL][0]


def _packed_kernel_name(lq: int, lk: int, h: int, block_q: int, block_k: int,
                        native_long_kv: bool):
    """The packed-layout kernel JAX ``_flash`` picks, or None: the
    ``native_long_kv`` branch for one kv block, then the ``_CROSS_IMPL``
    levers for kv <= 256."""
    if block_k != lk:
        return None
    if native_long_kv:
        bq = block_q if lk <= 256 else min(64, block_q)
        while lq % bq:
            bq //= 2
        if bq >= 8:
            return "_kernel_mh_nat"
    if lk > 256:
        return None
    if _CROSS_IMPL == "xpk" and lk <= _CROSS_MAX_KV and lq >= 4 * h * _CROSS_MAX_KV:
        return "_kernel_cross_packed"
    if _CROSS_IMPL in ("nat", "xpk"):
        return "_kernel_mh_nat"
    return None


# --- kernel launches ---------------------------------------------------------

def _check_bf16(what, *tensors):
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"{what}: the kernel takes bf16 q, k, v")


def _row_view(what, t):
    """``t`` as the kernel takes it: unit stride along D (one copy where it
    is not), rows 16-byte aligned; raises otherwise."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{what}: rows must be 16-byte aligned, got strides {t.stride()}")
    return t


# --- TMA geometry of the wgmma core (csrc/attn_sm90.cuh) -----------------------

_GEOM_LEN = 10  # per operand: 4 dims, 3 byte strides, 2 box dims, swizzle


def _kv_tile(d: int, lk: int, name: str) -> int:
    """kv rows per tile of the wgmma core's body that TPU kernel ``name``
    launches at (D, Lk): the library's own choice (``attn_bhld_tile``), which
    the k and v boxes of the geometry must match."""
    lib = _build.load("flash_attention_bhld", _SIGNATURES_BHLD)
    return lib.attn_bhld_tile(d, lk, _MODE_OF[name])


def _tma_map(what, t, box, swizzle):
    """TMA geometry of one 4-D view ``t`` whose last dim has unit stride:
    dims innermost first, the byte strides of dims 1-3, the box and the
    swizzle (0 or 128 bytes). Raises where the TMA cannot take the view: a
    byte stride that is not a multiple of 16, or a base address not 16-byte
    aligned. (A dim of size 1 is never stepped along; its stride is rounded
    up to 16 bytes.)"""
    shape, stride = tuple(t.shape), t.stride()
    if len(shape) != 4 or stride[3] != 1:
        raise ValueError(f"{what}: a 4-D view with unit stride along its last dim, got "
                         f"shape {shape} strides {stride}")
    strides = []
    for i in (2, 1, 0):
        sb = stride[i] * t.element_size()
        if shape[i] == 1:
            sb = max(16, -(-sb // 16) * 16)
        if sb % 16:
            raise ValueError(f"{what}: the TMA needs byte strides that are multiples of 16; "
                             f"got {sb} bytes along dim {i} (strides {stride})")
        strides.append(sb)
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: the TMA needs a 16-byte aligned base address; got "
                         f"{t.data_ptr():#x}")
    return (shape[3], shape[2], shape[1], shape[0], *strides, *box, swizzle)


def _tma_geometry(what, q, k, v, out, dmajor: bool, bk: int):
    """The TMA geometry of the four operands of the wgmma core, in the
    order and with the boxes the kernel expects (``_GEOM_LEN`` values each),
    for kv tiles of ``bk`` rows (the library's: ``attn_eod_tile``,
    :func:`_kv_tile`).

    ``dmajor``: q, v, out (B, H, D, L) and k (B, H, L, D), as
    ``flash_mha_eod`` has them; else all four (B, H, L, D). K-major tiles
    (rows, 64 columns) and the d-major q and v tiles (d rows, 64 tokens) are
    read with the 128-byte swizzle that ``wgmma`` reads; the 64-column box
    over D = 40 zero-fills the contraction padding, and rows past the
    sequence come in as zeros. The output box is stored unswizzled and
    clipped to the tensor."""
    d = k.shape[3]
    if dmajor:
        boxes = ((64, -(-d // 16) * 16, 128), (64, bk, 128), (64, d, 128), (64, d, 0))
    else:
        boxes = ((64, 64, 128), (64, bk, 128), (64, bk, 128), (d, 64, 0))
    names = ("q", "k", "v", "out")
    return tuple(x for name, t, (b0, b1, sw) in zip(names, (q, k, v, out), boxes)
                 for x in _tma_map(f"{what} {name}", t, (b0, b1), sw))


def _geometry_arg(geom):
    """The table as a C array (a ``c_void_p`` argument of the launch; read,
    never written, by the library)."""
    return (ctypes.c_longlong * len(geom))(*geom)


def map_cache_stats() -> dict:
    """{library: (hits, misses)} of the tensor-map caches of the two
    attention libraries since they were loaded (needs the card)."""
    out = {}
    for name, sigs, fn in (("flash_attention", _SIGNATURES, "attn_eod_map_cache_stats"),
                           ("flash_attention_bhld", _SIGNATURES_BHLD,
                            "attn_bhld_map_cache_stats")):
        counts = (ctypes.c_longlong * 2)()
        getattr(_build.load(name, sigs), fn)(counts)
        out[name] = tuple(counts)
    return out


def _launch_bhld(q, k, v, sm_scale, name, out=None):
    """Launch ``flash_attention_bhld.cu`` in the mode of TPU kernel ``name``
    on (B, H, L, D) views; ``out``, a (B, H, Lq, D) view to write (else a new
    contiguous tensor)."""
    what = f"flash_mha_bhld[{name}]"
    _build.require_cuda(what, q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape or min(lq, lk) < 1:
        raise ValueError(f"{what}: q (B,H,Lq,D), k and v (B,H,Lk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _check_bf16(what, q, k, v)
    lib = _build.load("flash_attention_bhld", _SIGNATURES_BHLD)
    if not lib.attn_bhld_supports(d):
        raise ValueError(f"{what}: kernel takes head_dim 40, 80 or 160; got D={d}")
    if name == "_kernel_cross_packed" and lk > _CROSS_MAX_KV:
        raise ValueError(f"{what}: kv at most {_CROSS_MAX_KV}; got {lk}")
    q, k, v = (_row_view(what, t) for t in (q, k, v))
    if out is None:
        out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    out = _row_view(what, out)
    mode = _MODE_OF[name]
    table = _tma_geometry(what, q, k, v, out, dmajor=False, bk=lib.attn_bhld_tile(d, lk, mode))
    p = _build.ptr
    err = lib.attn_bhld_launch(p(q), p(k), p(v), p(out), b, h, d, lq, lk,
                               _geometry_arg(table), float(sm_scale * LOG2_E), mode,
                               _build.stream_ptr(q))
    _build.check(err, what)
    flash_mha_bhld.launches[name] += 1
    return out


def _launch_packed(q, k, v, sm_scale, name):
    """The packed-layout kernels on (B, L, H, D) views of the packed
    projections; the output is written packed, (B, Lq, H, D) contiguous."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bhld(*(a.transpose(1, 2) for a in (q, k, v)), sm_scale, name,
                 out=out.transpose(1, 2))
    return out


def _launch(qt, k, vt, sm_scale):
    _build.require_cuda("flash_mha_eod", qt, k, vt)
    b, h, d, l = qt.shape
    if k.shape != (b, h, l, d) or vt.shape != (b, h, d, l):
        raise ValueError(
            f"flash_mha_eod: self-attention shapes qt/vt (B,H,D,L), k (B,H,L,D); "
            f"got {tuple(qt.shape)}, {tuple(k.shape)}, {tuple(vt.shape)}")
    _check_bf16("flash_mha_eod", qt, k, vt)
    lib = _build.load("flash_attention", _SIGNATURES)
    tile = lib.attn_eod_tile()
    if not lib.attn_eod_supports(d) or l % tile:
        raise ValueError(
            f"flash_mha_eod: kernel takes head_dim 40, 80 or 160 and L a "
            f"multiple of {tile}; got D={d}, L={l}")
    out = torch.empty((b, h, d, l), dtype=qt.dtype, device=qt.device)
    geom = _tma_geometry("flash_mha_eod", qt, k, vt, out, dmajor=True, bk=tile)
    p = _build.ptr
    err = lib.attn_eod_launch(p(qt), p(k), p(vt), p(out), b, h, d, l, _geometry_arg(geom),
                              float(sm_scale * LOG2_E), _build.stream_ptr(qt))
    _build.check(err, "flash_mha_eod")
    flash_mha_eod.launches += 1
    return out


def _jvp_through(reference, ctx, tangents):
    primals = ctx.saved_tensors
    tangents = tuple(torch.zeros_like(p) if t is None else t
                     for p, t in zip(primals, tangents))
    _, out_t = torch.func.jvp(lambda a, b, c: reference(a, b, c, ctx.sm_scale),
                              primals, tangents)
    return out_t


class _FlashBhld(torch.autograd.Function):
    """Kernel (CUDA) or its plain version (CPU) forward on (B, H, L, D);
    tangents through :func:`_reference_bhld`."""

    @staticmethod
    def forward(q, k, v, sm_scale, block_q, block_k, name):
        if q.is_cuda:
            return _launch_bhld(q, k, v, sm_scale, name)
        return _plain(name, q, k, v, sm_scale, block_q, block_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:3])
        ctx.sm_scale = inputs[3]

    @staticmethod
    def jvp(ctx, q_t, k_t, v_t, *_):
        return _jvp_through(_reference_bhld, ctx, (q_t, k_t, v_t))


class _FlashPacked(torch.autograd.Function):
    """A packed-layout kernel (CUDA) or its plain version (CPU) forward on
    (B, L, H, D); tangents through :func:`_reference`, as JAX
    ``_flash_jvp``."""

    @staticmethod
    def forward(q, k, v, sm_scale, name):
        if q.is_cuda:
            return _launch_packed(q, k, v, sm_scale, name)
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
        return _plain(name, q, k, v, sm_scale, None, None).transpose(1, 2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:3])
        ctx.sm_scale = inputs[3]

    @staticmethod
    def jvp(ctx, q_t, k_t, v_t, *_):
        return _jvp_through(_reference, ctx, (q_t, k_t, v_t))


class _FlashEod(torch.autograd.Function):
    """Kernel (CUDA) or its plain version (CPU) forward in the d-major
    layout; tangents through :func:`_reference_eod`, as JAX
    ``_flash_eod_jvp``."""

    @staticmethod
    def forward(qt, k, vt, sm_scale):
        if qt.is_cuda:
            return _launch(qt, k, vt, sm_scale)
        return _plain("_make_pvtd_kernel", qt.transpose(-1, -2), k, vt.transpose(-1, -2),
                      sm_scale, None, None).transpose(-1, -2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:3])
        ctx.sm_scale = inputs[3]

    @staticmethod
    def jvp(ctx, qt_t, k_t, vt_t, _):
        return _jvp_through(_reference_eod, ctx, (qt_t, k_t, vt_t))


# --- entry points ------------------------------------------------------------

def flash_mha_bhld(q, k, v, *, sm_scale: float | None = None,
                   block_q: int | None = None, block_k: int | None = None):
    """softmax(q k^T * sm_scale) v on tensors already in (B, H, L, D): the
    ``flash_eo`` entry. Same kernels and dispatch as :func:`flash_mha`, but
    kv <= 256 goes to a kernel too, as in JAX; the plain version when the
    sequence does not tile."""
    d = q.shape[3]
    lq, lk = q.shape[2], k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    block_q, block_k = _blocks(lq, lk, block_q, block_k)
    if not _tiles(block_q, block_k, lk):
        return _reference_bhld(q, k, v, sm_scale)
    return _FlashBhld.apply(q, k, v, float(sm_scale), block_q, block_k,
                            _kernel_name(lk, block_k))


def flash_mha(q, k, v, *, sm_scale: float | None = None, block_q: int | None = None,
              block_k: int | None = None, native_long_kv: bool = False):
    """softmax(q k^T * sm_scale) v on (B, L, H, D). kv <= 256 is plain
    attention (or a packed-layout kernel under ``_CROSS_IMPL``); 256 < kv <=
    1024 the single-pass kernel; longer kv in one block (up to 4096) the
    ``_LONG_IMPL`` kernel; several kv blocks the online-softmax kernel.
    ``native_long_kv=True`` sends every row that fits one kv block to the
    packed-layout ``_kernel_mh_nat``. A caller's ``block_k`` only takes
    effect above 1024 kv tokens. The plain version when the sequence does
    not tile."""
    h, d = q.shape[2], q.shape[3]
    lq, lk = q.shape[1], k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    block_q, block_k = _blocks(lq, lk, block_q, block_k)
    if not _tiles(block_q, block_k, lk):
        return _reference(q, k, v, sm_scale)
    name = _packed_kernel_name(lq, lk, h, block_q, block_k, native_long_kv)
    if name is not None:
        return _FlashPacked.apply(q, k, v, float(sm_scale), name)
    if block_k == lk and lk <= 256:
        return _reference(q, k, v, sm_scale)
    out = _FlashBhld.apply(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           float(sm_scale), block_q, block_k, _kernel_name(lk, block_k))
    return out.transpose(1, 2)


def flash_mha_eod(qt, k, vt, *, sm_scale: float | None = None,
                  block_q: int | None = None):
    """softmax(q k^T * sm_scale) v with qt/vt/out (B, H, D, L), k (B, H, L, D):
    the ``flash_eod`` entry, for one kv block of 256 < kv <= 4096. Anything
    else (several kv blocks, short rows, a q block that is not a multiple of
    128 per chain) transposes into :func:`flash_mha_bhld`'s dispatch."""
    d, lq = qt.shape[2], qt.shape[3]
    lk = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    chains, bq_default = ((_EOD_CHAINS_LONG, _EOD_BLOCK_Q) if lk > 1024
                          else (_EOD_CHAINS_MID, _EOD_BLOCK_Q_MID))
    block_q = block_q or min(bq_default, lq)
    while lq % block_q:
        block_q //= 2
    if lk > 4096 or lk <= 256 or lk % 8 or d % 8 or block_q % (128 * chains):
        out = flash_mha_bhld(qt.transpose(2, 3), k, vt.transpose(2, 3), sm_scale=sm_scale)
        return out.transpose(2, 3)
    return _FlashEod.apply(qt, k, vt, float(sm_scale))


flash_mha_eod.launches = 0
flash_mha_bhld.launches = flash_mha.launches = {name: 0 for name in _MODE_OF}
