"""AlphaFold2 residue constants (public scientific tables), npz-backed
(port of ``superdiff_tpu/models/protein/residue_constants.py``, with its
own copy of the two data files beside it).

The arrays in ``_residue_constants.npz`` are the standard AF2 amino-acid
tables (atom37/atom14 layouts, chi-angle atom indices, idealized rigid-group
frames and literature atom positions). They parameterize the all-atom
reconstruction and torsion machinery in ``all_atom37.py``. Host numpy:
callers move what they index to their device.
"""

from __future__ import annotations

import json
import os

import numpy as np

_DIR = os.path.dirname(__file__)
_NPZ = np.load(os.path.join(_DIR, "_residue_constants.npz"))
with open(os.path.join(_DIR, "_residue_constants_meta.json")) as _f:
    _META = json.load(_f)

restypes: str = _META["restypes"]  # "ARNDCQEGHILKMFPSTWYV"
restype_num: int = len(restypes)  # 20
restypes_with_x: str = restypes + "X"  # index 20 = unknown
atom_types: list = _META["atom_types"]  # 37 atom names, atom37 order
atom_order: dict = {a: i for i, a in enumerate(atom_types)}
restype_order: dict = {r: i for i, r in enumerate(restypes)}
restype_1to3: dict = _META["restype_1to3"]
resname_to_idx: dict = {v: restype_order[k] for k, v in restype_1to3.items()}
resname_to_idx["UNK"] = restype_num

GLY_IDX: int = _META["gly_idx"]
ALA_IDX: int = _META["ala_idx"]
CA_IDX: int = _META["ca_idx"]
CB_IDX: int = _META["cb_idx"]
N_IDX: int = _META["n_idx"]
C_IDX: int = _META["c_idx"]
O_IDX: int = _META["o_idx"]

# (21, 37) 1.0 where the atom exists for the residue type
STANDARD_ATOM_MASK = np.asarray(_NPZ["standard_atom_mask"])
# (20, 4) which chi angles exist per residue type
chi_angles_mask = np.asarray(_NPZ["chi_angles_mask"])
# (21, 4) chi angles with 180-degree rotamer symmetry
chi_pi_periodic = np.asarray(_NPZ["chi_pi_periodic"])
# (21, 4, 4) atom37 indices of the 4 atoms defining each chi angle
chi_atom_indices = np.asarray(_NPZ["chi_atom_indices"])
# (21, 8, 4, 4) idealized default frame per rigid group
restype_rigid_group_default_frame = np.asarray(
    _NPZ["restype_rigid_group_default_frame"]
)
# (21, 14) rigid group each atom14 slot belongs to
restype_atom14_to_rigid_group = np.asarray(_NPZ["restype_atom14_to_rigid_group"])
# (21, 14) atom14 existence mask
restype_atom14_mask = np.asarray(_NPZ["restype_atom14_mask"])
# (21, 14, 3) idealized atom positions in their rigid group's frame
restype_atom14_rigid_group_positions = np.asarray(
    _NPZ["restype_atom14_rigid_group_positions"]
)
# (21, 14) / (21, 37): per-restype atom14 <-> atom37 index maps
restype_atom14_to_atom37 = np.asarray(_NPZ["restype_atom14_to_atom37"])
restype_atom37_to_atom14 = np.asarray(_NPZ["restype_atom37_to_atom14"])
restype_atom14_exists = np.asarray(_NPZ["restype_atom14_exists"])
