"""All-atom37 geometry: torsions, idealized reconstruction, frame constructions
(port of ``superdiff_tpu/models/protein/all_atom37.py``; the openfold
all-atom machinery the reference Proteus model calls at inference).

* atom37_to_torsion_angles, pseudo_beta_fn;
* torsion_angles_to_frames, frames_to_atom14_pos, atom14_to_atom37;
* from_3_points (Gram-Schmidt) and make_transform_from_reference, with the
  vendored openfold copies' quirk of writing the c2 z-row into ``c1_rots``;
* make_atom14_masks from the per-restype tables.

Frames are plain (rot (..., 3, 3), trans (..., 3)) tuples.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from . import residue_constants as rc


def _table(a, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A residue-constant table on ``like``'s device."""
    return torch.as_tensor(a, dtype=dtype, device=like.device)


def _mv(m, v):
    """``einsum("...ij,...j->...i")``."""
    return (m @ v[..., None])[..., 0]


def pseudo_beta_fn(aatype, atom37, atom37_mask):
    """CB position (CA for glycine); with its mask when one is given."""
    is_gly = aatype == rc.GLY_IDX
    beta = torch.where(is_gly[..., None], atom37[..., rc.CA_IDX, :],
                       atom37[..., rc.CB_IDX, :])
    if atom37_mask is None:
        return beta
    mask = torch.where(is_gly, atom37_mask[..., rc.CA_IDX], atom37_mask[..., rc.CB_IDX])
    return beta, mask


def from_3_points(p_neg_x_axis, origin, p_xy_plane, eps: float = 1e-8):
    """Gram-Schmidt frame construction (Alg. 21). Returns (rot, trans)."""
    e0 = origin - p_neg_x_axis
    e1 = p_xy_plane - origin
    e0 = e0 / torch.sqrt(torch.sum(e0**2, dim=-1, keepdim=True) + eps)
    dot = torch.sum(e0 * e1, dim=-1, keepdim=True)
    e1 = e1 - e0 * dot
    e1 = e1 / torch.sqrt(torch.sum(e1**2, dim=-1, keepdim=True) + eps)
    e2 = torch.linalg.cross(e0, e1, dim=-1)
    return torch.stack([e0, e1, e2], dim=-1), origin  # columns e0, e1, e2


def make_transform_from_reference(n_xyz, ca_xyz, c_xyz, eps: float = 1e-20):
    """Reference-frame construction of the vendored openfold copies, their
    quirk included: row 2 of ``c1_rots`` holds the c2 terms."""
    t = -ca_xyz
    n = n_xyz + t
    c = c_xyz + t
    c_x, c_y, c_z = c[..., 0], c[..., 1], c[..., 2]
    norm = torch.sqrt(eps + c_x**2 + c_y**2)
    sin_c1, cos_c1 = -c_y / norm, c_x / norm
    zeros = torch.zeros_like(sin_c1)
    ones = torch.ones_like(sin_c1)
    norm2 = torch.sqrt(eps + c_x**2 + c_y**2 + c_z**2)
    sin_c2, cos_c2 = c_z / norm2, torch.sqrt(c_x**2 + c_y**2) / norm2
    c1_rots = torch.stack(
        [cos_c1, -sin_c1, zeros,
         sin_c1, cos_c1, zeros,
         -sin_c2, zeros, cos_c2], dim=-1,
    ).reshape(sin_c1.shape + (3, 3))
    c2_rots = torch.stack(
        [cos_c2, zeros, sin_c2,
         zeros, ones, zeros,
         zeros, zeros, zeros], dim=-1,
    ).reshape(sin_c1.shape + (3, 3))
    c_rots = c2_rots @ c1_rots
    n2 = _mv(c_rots, n)
    norm3 = torch.sqrt(eps + n2[..., 1] ** 2 + n2[..., 2] ** 2)
    sin_n, cos_n = -n2[..., 2] / norm3, n2[..., 1] / norm3
    n_rots = torch.stack(
        [ones, zeros, zeros,
         zeros, cos_n, -sin_n,
         zeros, sin_n, cos_n], dim=-1,
    ).reshape(sin_c1.shape + (3, 3))
    return (n_rots @ c_rots).transpose(-1, -2), ca_xyz


def _gather_atoms(atom37, idx):
    """atom37 (..., N, 37, 3), idx (..., N, 4, 4) -> (..., N, 4, 4, 3)."""
    src = atom37[..., None, :, :].expand(idx.shape[:-1] + atom37.shape[-2:])
    return torch.gather(src, -2, idx[..., None].expand(idx.shape + (3,)))


def _gather_mask(mask, idx):
    """mask (..., N, 37), idx (..., N, 4, 4) -> (..., N, 4, 4)."""
    src = mask[..., None, :].expand(idx.shape[:-1] + mask.shape[-1:])
    return torch.gather(src, -1, idx)


def atom37_to_torsion_angles(aatype, atom37, atom37_mask):
    """Returns (torsion_sin_cos (..., 7, 2), alt (..., 7, 2), mask (..., 7))."""
    aatype = torch.clamp(aatype, max=20).long()
    prev_pos = torch.cat([torch.zeros_like(atom37[..., :1, :, :]), atom37[..., :-1, :, :]],
                         dim=-3)
    prev_mask = torch.cat([torch.zeros_like(atom37_mask[..., :1, :]),
                           atom37_mask[..., :-1, :]], dim=-2)
    pre_omega = torch.cat([prev_pos[..., 1:3, :], atom37[..., :2, :]], dim=-2)
    phi = torch.cat([prev_pos[..., 2:3, :], atom37[..., :3, :]], dim=-2)
    psi = torch.cat([atom37[..., :3, :], atom37[..., 4:5, :]], dim=-2)
    pre_omega_mask = (torch.prod(prev_mask[..., 1:3], dim=-1)
                      * torch.prod(atom37_mask[..., :2], dim=-1))
    phi_mask = prev_mask[..., 2] * torch.prod(atom37_mask[..., :3], dim=-1)
    psi_mask = torch.prod(atom37_mask[..., :3], dim=-1) * atom37_mask[..., 4]

    chi_idx = _table(rc.chi_atom_indices, aatype, torch.long)[aatype]  # (..., 4, 4)
    chis_pos = _gather_atoms(atom37, chi_idx)  # (..., 4, 4, 3)
    chis_atom_mask = torch.prod(_gather_mask(atom37_mask, chi_idx), dim=-1)
    chi_mask_table = torch.cat([_table(rc.chi_angles_mask, aatype, torch.float32),
                                torch.zeros((1, 4), device=aatype.device)], dim=0)
    chis_mask = chi_mask_table[aatype] * chis_atom_mask

    torsions_pos = torch.cat([pre_omega[..., None, :, :], phi[..., None, :, :],
                              psi[..., None, :, :], chis_pos], dim=-3)  # (..., 7, 4, 3)
    torsion_mask = torch.cat([pre_omega_mask[..., None], phi_mask[..., None],
                              psi_mask[..., None], chis_mask], dim=-1)
    rot, trans = from_3_points(torsions_pos[..., 1, :], torsions_pos[..., 2, :],
                               torsions_pos[..., 0, :])
    # invert().apply(p) = R^T (p - t)
    rel = _mv(rot.transpose(-1, -2), torsions_pos[..., 3, :] - trans)
    sin_cos = torch.stack([rel[..., 2], rel[..., 1]], dim=-1)
    sin_cos = sin_cos / torch.sqrt(torch.sum(sin_cos**2, dim=-1, keepdim=True) + 1e-8)
    sign = torch.tensor([1.0, 1.0, -1.0, 1.0, 1.0, 1.0, 1.0], device=atom37.device)
    sin_cos = sin_cos * sign[..., None]
    chi_amb = _table(rc.chi_pi_periodic, aatype, torch.float32)[aatype]
    mirror = torch.cat([torch.ones(aatype.shape + (3,), device=atom37.device),
                        1.0 - 2.0 * chi_amb], dim=-1)
    return sin_cos, sin_cos * mirror[..., None], torsion_mask


def make_atom14_masks(aatype) -> dict:
    """Per-residue atom14 / atom37 index maps and existence masks."""
    aatype = torch.clamp(aatype, max=20).long()
    return {
        "residx_atom14_to_atom37": _table(rc.restype_atom14_to_atom37, aatype,
                                          torch.long)[aatype],
        "residx_atom37_to_atom14": _table(rc.restype_atom37_to_atom14, aatype,
                                          torch.long)[aatype],
        "atom14_atom_exists": _table(rc.restype_atom14_exists, aatype,
                                     torch.float32)[aatype],
        "atom37_atom_exists": _table(rc.STANDARD_ATOM_MASK, aatype, torch.float32)[aatype],
    }


def _compose(f1, f2):
    """(rot, trans) composition r1 o r2."""
    r1, t1 = f1
    r2, t2 = f2
    return r1 @ r2, _mv(r1, t2) + t1


def torsion_angles_to_frames(rot, trans, alpha, aatype):
    """openfold ``feats.torsion_angles_to_frames``: the 8 rigid-group frames.
    rot / trans the backbone frames (..., 3, 3) / (..., 3), alpha (..., 7, 2)
    [sin, cos]; returns (rot8 (..., 8, 3, 3), trans8 (..., 8, 3))."""
    aatype = aatype.long()
    default_4x4 = _table(rc.restype_rigid_group_default_frame, rot, torch.float32)[aatype]
    def_rot = default_4x4[..., :3, :3]
    def_trans = default_4x4[..., :3, 3]
    bb_rot = torch.zeros(alpha.shape[:-2] + (1, 2), device=alpha.device)
    bb_rot[..., 1] = 1.0
    alpha = torch.cat([bb_rot, alpha], dim=-2)  # (..., 8, 2)
    sin_a, cos_a = alpha[..., 0], alpha[..., 1]
    zeros = torch.zeros_like(sin_a)
    ones = torch.ones_like(sin_a)
    x_rot = torch.stack(
        [ones, zeros, zeros,
         zeros, cos_a, -sin_a,
         zeros, sin_a, cos_a], dim=-1,
    ).reshape(sin_a.shape + (3, 3))
    rot8, trans8 = _compose((def_rot, def_trans),
                            (x_rot, torch.zeros(sin_a.shape + (3,), device=alpha.device)))
    # chain the chi frames: chi2 <- chi1, chi3 <- chi2, chi4 <- chi3
    chi1 = (rot8[..., 4, :, :], trans8[..., 4, :])
    chi2 = _compose(chi1, (rot8[..., 5, :, :], trans8[..., 5, :]))
    chi3 = _compose(chi2, (rot8[..., 6, :, :], trans8[..., 6, :]))
    chi4 = _compose(chi3, (rot8[..., 7, :, :], trans8[..., 7, :]))
    rot_all = torch.cat([rot8[..., :5, :, :], chi2[0][..., None, :, :],
                         chi3[0][..., None, :, :], chi4[0][..., None, :, :]], dim=-3)
    trans_all = torch.cat([trans8[..., :5, :], chi2[1][..., None, :], chi3[1][..., None, :],
                           chi4[1][..., None, :]], dim=-2)
    # compose with the global backbone frame
    g_rot = rot[..., None, :, :] @ rot_all
    g_trans = _mv(rot[..., None, :, :], trans_all) + trans[..., None, :]
    return g_rot, g_trans


def frames_to_atom14_pos(rot8, trans8, aatype):
    """Idealized atom14 positions from the 8 rigid-group frames."""
    aatype = aatype.long()
    group_idx = _table(rc.restype_atom14_to_rigid_group, rot8, torch.long)[aatype]
    group_mask = F.one_hot(group_idx, 8).to(rot8.dtype)  # (..., 14, 8)
    r_atom = torch.einsum("...ag,...gij->...aij", group_mask, rot8)
    t_atom = torch.einsum("...ag,...gi->...ai", group_mask, trans8)
    lit = _table(rc.restype_atom14_rigid_group_positions, rot8, torch.float32)[aatype]
    pred = _mv(r_atom, lit) + t_atom
    return pred * _table(rc.restype_atom14_mask, rot8, torch.float32)[aatype][..., None]


def atom14_to_atom37(atom14, aatype):
    """Scatter atom14 positions into the atom37 layout."""
    maps = make_atom14_masks(aatype)
    idx = maps["residx_atom37_to_atom14"]  # (..., 37)
    a37 = torch.gather(atom14, -2, idx[..., None].expand(idx.shape + (3,)))
    return a37 * maps["atom37_atom_exists"][..., None]
