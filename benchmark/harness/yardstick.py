"""The benchmark's yardstick: the card's peaks, the least time of a kernel's
work (its roofline), and model FLOPs counted on the ``meta`` device.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at the
full power limit of 700 W; a run prints the card's own limit beside them.
A roofline share counts only the operations a product needs and the bytes
of its inputs and outputs read or written once: no exponentials, no
re-reads, whatever kernel serves the work.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

PEAKS = {
    "NVIDIA H100": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}
DEFAULT_PEAK = "NVIDIA H100"


def peak(kind: str = DEFAULT_PEAK) -> dict:
    """The peak rates of the card named ``kind`` (its first matching entry)."""
    for name, p in PEAKS.items():
        if kind.startswith(name):
            return p
    raise KeyError(f"no peaks for {kind!r}; known: {sorted(PEAKS)}")


def least_seconds(flops: float, nbytes: float, kind: str = DEFAULT_PEAK) -> float:
    """The least time the card could take: the larger of FLOPs over the
    bf16 dense peak and bytes over the HBM bandwidth."""
    p = peak(kind)
    return max(flops / p["bf16_flops"], nbytes / p["hbm_bytes"])


def attention_work(b: int, h: int, lq: int, lk: int, d: int, elem: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of softmax attention: the two products, 4 B H Lq Lk D
    FLOPs; q and o (B H Lq D) and k and v (B H Lk D) once, ``elem`` bytes
    each."""
    return 4.0 * b * h * lq * lk * d, float(elem) * b * h * d * (2 * lq + 2 * lk)


def geglu_ffn_work(m: int, c: int, f: int, elem: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of a GEGLU FFN sub-block over M tokens of width C with
    hidden width F: the C -> 2F and F -> C products, 6 M C F FLOPs; the input
    and output (M C) and the two weights (3 C F) once, ``elem`` bytes each."""
    return 6.0 * m * c * f, float(elem) * (2 * m * c + 3 * c * f)


def least_seconds_of(works: Iterable[Tuple[float, float]], kind: str = DEFAULT_PEAK) -> float:
    """The summed least time of several launches' (FLOPs, bytes)."""
    return sum(least_seconds(fl, by, kind) for fl, by in works)


def count_flops(fn: Callable[[], object]) -> int:
    """The FLOPs ``torch.utils.flop_counter`` counts while ``fn`` runs
    (products and convolutions; call it on ``meta`` tensors, which costs no
    arithmetic)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            fn()
    return int(counter.get_total_flops())
