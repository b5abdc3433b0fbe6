"""Numbers that compare the program's answers with the reference's, and
the verdict against each number's limit."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def row_gap(prog: torch.Tensor, ref: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Per row (first axis): ||prog - ref|| / ||base||, float64."""
    b = prog.shape[0]
    num = (prog.double() - ref.double()).reshape(b, -1).norm(dim=1)
    return num / base.double().reshape(b, -1).norm(dim=1).clamp_min(1e-30)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[str]]:
    """(every number within its limit, one line per number: name, value,
    limit). A number without a limit, a limit without a number, or a
    number that is not finite fails."""
    lines, ok = [], set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(name), limits.get(name)
        good = v is not None and lim is not None and v == v and v <= lim
        ok = ok and good
        lines.append(f"check {name} {v!r} limit {lim!r} {'ok' if good else 'FAILED'}")
    return ok, lines
