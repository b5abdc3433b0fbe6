"""Backbone geometry: rigid frames -> atom37 coordinates -> PDB text (port
of ``superdiff_tpu/models/protein/backbone.py``).

Idealized peptide geometry places N, CA, C (+ CB) from each residue frame,
the carbonyl O from the psi torsion (or an idealized default), and a
minimal PDB writer emits backbone records.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import rigid

# Idealized backbone atom positions in the residue's local frame (angstroms),
# standard AF2 rigid-group geometry for the backbone group.
IDEAL_N = np.asarray([-0.525, 1.363, 0.0], np.float32)
IDEAL_CA = np.asarray([0.0, 0.0, 0.0], np.float32)
IDEAL_C = np.asarray([1.526, 0.0, 0.0], np.float32)
IDEAL_CB = np.asarray([-0.529, -0.774, -1.205], np.float32)
# Idealized O relative to the C-frame before the psi rotation.
IDEAL_O = np.asarray([0.627, 1.062, 0.0], np.float32)

# atom37 slot indices (openfold residue_constants convention)
ATOM37_N, ATOM37_CA, ATOM37_C, ATOM37_CB, ATOM37_O = 0, 1, 2, 3, 4


def to_atom37(rigids7: torch.Tensor, psi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Place backbone atoms from tensor-7 rigids (..., n, 7), translations
    in angstroms; ``psi`` (..., n, 2) sin/cos of the psi torsion places the
    carbonyl O (idealized trans placement when omitted). Returns
    (..., n, 37, 3) with N/CA/C/CB/O filled, the rest zero."""
    rot = rigid.rigid_rotmat(rigids7)
    trans = rigid.rigid_trans(rigids7)

    def local(a):
        return torch.as_tensor(a, device=rigids7.device)

    def place(a):
        return rot @ local(a) + trans

    n_xyz, ca_xyz, c_xyz, cb_xyz = (place(IDEAL_N), place(IDEAL_CA), place(IDEAL_C),
                                    place(IDEAL_CB))
    # O sits in the frame anchored at C, rotated about the CA->C axis by psi.
    if psi is None:
        sin_psi = torch.zeros(rigids7.shape[:-1], device=rigids7.device)
        cos_psi = -torch.ones(rigids7.shape[:-1], device=rigids7.device)
    else:
        p = psi / torch.linalg.norm(psi, dim=-1, keepdim=True).clamp_min(1e-6)
        sin_psi, cos_psi = p[..., 0], p[..., 1]
    axis = c_xyz - ca_xyz
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True).clamp_min(1e-6)
    psi_rot = rigid.rotvec_to_rotmat(axis * torch.atan2(sin_psi, cos_psi)[..., None])
    o_local = rot @ local(IDEAL_O)
    o_xyz = c_xyz + (psi_rot @ o_local[..., None])[..., 0]

    out = torch.zeros(rigids7.shape[:-1] + (37, 3), dtype=rigids7.dtype,
                      device=rigids7.device)
    out[..., ATOM37_N, :] = n_xyz
    out[..., ATOM37_CA, :] = ca_xyz
    out[..., ATOM37_C, :] = c_xyz
    out[..., ATOM37_CB, :] = cb_xyz
    out[..., ATOM37_O, :] = o_xyz
    return out


_BB_ATOMS = [("N", ATOM37_N, "N"), ("CA", ATOM37_CA, "C"), ("C", ATOM37_C, "C"),
             ("O", ATOM37_O, "O"), ("CB", ATOM37_CB, "C")]

_AA3 = [
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
]


def to_pdb(
    atom37,
    aatype: Optional[np.ndarray] = None,
    res_mask: Optional[np.ndarray] = None,
    b_factors: Optional[np.ndarray] = None,
    chain: str = "A",
) -> str:
    """Minimal PDB writer for backbone atoms; ``atom37`` (n, 37, 3) as a
    numpy array or a tensor on any device.

    The ATOM records keep the PDB format's columns: the atom name from
    column 14 (13-16), altLoc blank in 17, the residue name in 18-20, the
    chain in 22, the residue number in 23-26, x / y / z in 31-38 / 39-46 /
    47-54 (``%8.3f``: -999.999 to 9999.999 A), occupancy 55-60, B-factor
    61-66, the element in 77-78. (JAX's writer has no altLoc column and
    writes every field from the residue name on one column early, so a
    coordinate of 100 A or more runs into its neighbour.)"""
    if isinstance(atom37, torch.Tensor):
        atom37 = atom37.detach().cpu().numpy()
    atom37 = np.asarray(atom37)
    n = atom37.shape[0]
    aatype = np.zeros(n, np.int32) if aatype is None else np.asarray(aatype)
    res_mask = np.ones(n) if res_mask is None else np.asarray(res_mask)
    b = np.zeros(n) if b_factors is None else np.asarray(b_factors)
    lines, serial = [], 1
    for i in range(n):
        if res_mask[i] <= 0:
            continue
        res3 = _AA3[int(aatype[i]) % 20]
        for name, slot, elem in _BB_ATOMS:
            if name == "CB" and res3 == "GLY":
                continue
            x, y, z = atom37[i, slot]
            lines.append(
                f"ATOM  {serial:>5}  {name:<3} {res3} {chain}{i + 1:>4}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{b[i]:6.2f}          {elem:>2}"
            )
            serial += 1
    lines.append("TER")
    lines.append("END")
    return "\n".join(lines) + "\n"
