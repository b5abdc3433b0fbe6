"""Sequence-parallel (ring) attention over a mesh axis (port of
``superdiff_tpu/parallel/sp.py``).

Q, K and V are split over the sequence axis: each rank owns an L/N-token
slice, and the K/V blocks rotate around the ring, one hop a step, with
``torch.distributed.batch_isend_irecv`` (send to the next rank of the
axis, receive from the previous one). The next block's transfer is posted
before the current block's matmuls and waited on after them, so the two
overlap. Each step's partial attention is merged into the online-softmax
state ``(m, l, o)``, kept in fp32; the block matmuls run in the input
dtype, as in JAX. The per-block compute is a plain einsum, as JAX's is
(no Pallas kernel there either). A ring of N ranks takes N steps and N - 1
transfers (JAX's last ``ppermute`` result is discarded): a ring of one
rank moves nothing. Non-causal only, as every attention of the framework.

Layout: per-rank shards ``(B, L/N, H, D)``, the UNet's native layout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh


def _rotate(tensors, mesh: Mesh, axis_name: str):
    """Post the one-hop rotation of ``tensors`` (send to the next rank of
    the axis, receive from the previous); returns (received, requests)."""
    ranks = mesh.ranks(axis_name)
    i, n = mesh.index(axis_name), len(ranks)
    group = mesh.group(axis_name)
    nxt, prv = ranks[(i + 1) % n], ranks[(i - 1) % n]
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recv]
    return recv, dist.batch_isend_irecv(ops)


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    axis_name: str,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Ring attention body on this rank's shards.

    Args:
      q, k, v: per-rank shards ``(B, L_shard, H, D)``; the global sequence
        is the concatenation of the shards along axis 1 in the axis' rank
        order.
      mesh, axis_name: the mesh axis the sequence is split over.
      sm_scale: softmax scale; defaults to ``1/sqrt(D)``.

    Returns this rank's output shard ``(B, L_shard, H, D)`` in q's dtype.
    """
    n = mesh.shape[axis_name]
    b, l_q, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / (d**0.5)
    o = torch.zeros((b, h, l_q, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, l_q), -torch.inf, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros((b, h, l_q), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for step in range(n):
        pending = None
        if step < n - 1:
            pending = _rotate((k_cur, v_cur), mesh, axis_name)
        # (B, H, Lq, Lk) block logits in fp32, the matmul in the input dtype
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k_cur).float() * sm_scale
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l_sum = l_sum * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v_cur.dtype), v_cur)
        o = o * corr[..., None] + pv.float()
        m = m_new
        if pending is not None:
            (k_cur, v_cur), reqs = pending
            for r in reqs:
                r.wait()
    out = o / l_sum[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis_name: str = "sp",
    sm_scale: Optional[float] = None,
    batch_axis: Optional[str] = None,
) -> torch.Tensor:
    """Sequence-parallel attention on full ``(B, L, H, D)`` operands.

    Every rank passes the full operands (JAX's global arrays); this rank
    takes its slice of the sequence over ``axis_name`` (and of the batch
    over ``batch_axis``), runs the ring, and the shards are all-gathered
    back, so every rank returns the full output. L must divide by the axis
    size (pad upstream; ragged shards would need a mask no caller has)."""
    n = mesh.shape[axis_name]
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(
            f"sequence length {q.shape[1]}/{k.shape[1]} not divisible by "
            f"mesh axis '{axis_name}' of size {n}")
    i = mesh.coords[axis_name]

    def shard(a):
        s = a.shape[1] // n
        a = a[:, i * s:(i + 1) * s]
        if batch_axis is not None:
            nb, j = mesh.shape[batch_axis], mesh.coords[batch_axis]
            if a.shape[0] % nb:
                raise ValueError(f"batch {a.shape[0]} not divisible by mesh axis "
                                 f"'{batch_axis}' of size {nb}")
            sb = a.shape[0] // nb
            a = a[j * sb:(j + 1) * sb]
        return a

    out = ring_attention_local(shard(q), shard(k), shard(v), mesh=mesh, axis_name=axis_name,
                               sm_scale=sm_scale)
    out = mesh.all_gather(out, axis_name, dim=1)
    if batch_axis is not None:
        out = mesh.all_gather(out, batch_axis, dim=0)
    return out
