"""PDB parsing and protein training data pipeline (port of
``superdiff_tpu/data/pdb.py``: host numpy, the backbone frames through the
port's ``all_atom37.from_3_points`` and ``rigid.rotmat_to_quat``).

The protein-tier data layer the reference builds on BioPython + mmCIF
processing (``applications/proteins/evaluation/data/{parsers,protein,
process_pdb_dataset}.py`` and ``se3diff_data`` processing, ~5.3k LoC;
behavior parity for the pieces the composition/training/eval paths need):

* :func:`parse_pdb` — ATOM records -> atom37 positions/mask, aatype,
  residue/chain indices (first model, first altloc; unknown residues map
  to UNK). Dependency-free (no BioPython in this image).
* :func:`backbone_frames` — AF2 group-0 backbone rigids from N/CA/C
  (``data_transforms.atom37_to_frames``: from_3_points(C, CA, N) composed
  with diag(-1, 1, -1)).
* :class:`ProteinDataset` — directory of PDBs -> length-filtered
  (``composition.yaml:56,66`` max_len 512 default), CA-centered, padded
  training batches {"rigids_0", "res_mask", "seq_idx"} for
  ``train/se3_trainer.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

import torch

from ..models.protein import residue_constants as rc
from ..models.protein.all_atom37 import from_3_points
from ..models.protein.rigid import rotmat_to_quat

_ATOM_IDX = {a: i for i, a in enumerate(rc.atom_types)}


@dataclasses.dataclass
class ParsedProtein:
    aatype: np.ndarray  # (N,) int32, 0..20 (UNK=20)
    atom37: np.ndarray  # (N, 37, 3) float32
    atom37_mask: np.ndarray  # (N, 37) float32
    residue_index: np.ndarray  # (N,) int32 (author numbering)
    chain_index: np.ndarray  # (N,) int32
    b_factors: np.ndarray  # (N, 37) float32

    def __len__(self):
        return self.aatype.shape[0]


def parse_pdb_string(pdb_str: str) -> ParsedProtein:
    """Parse ATOM records of the first model into atom37 arrays."""
    chain_ids: List[str] = []
    residues = {}  # (chain, resnum, icode) -> dict
    order: List[tuple] = []
    for line in pdb_str.splitlines():
        rec = line[:6]
        if rec == "ENDMDL":
            break  # first model only
        if rec != "ATOM  " and rec != "HETATM":
            continue
        atom_name = line[12:16].strip()
        altloc = line[16]
        resname = line[17:20].strip()
        chain = line[21]
        resnum = int(line[22:26])
        icode = line[26]
        if altloc not in (" ", "A"):
            continue
        if rec == "HETATM" and resname != "MSE":
            continue  # skip waters/ligands; selenomethionine -> MET
        if resname == "MSE":
            resname = "MET"
            if atom_name == "SE":
                atom_name = "SD"
        if atom_name not in _ATOM_IDX:
            continue
        key = (chain, resnum, icode)
        if key not in residues:
            residues[key] = {
                "resname": resname,
                "pos": np.zeros((37, 3), np.float32),
                "mask": np.zeros((37,), np.float32),
                "b": np.zeros((37,), np.float32),
            }
            order.append(key)
            if chain not in chain_ids:
                chain_ids.append(chain)
        r = residues[key]
        ai = _ATOM_IDX[atom_name]
        if r["mask"][ai]:
            continue  # keep the first occurrence
        r["pos"][ai] = [float(line[30:38]), float(line[38:46]), float(line[46:54])]
        r["mask"][ai] = 1.0
        try:
            r["b"][ai] = float(line[60:66])
        except ValueError:
            pass

    n = len(order)
    aatype = np.full((n,), rc.restype_num, np.int32)  # UNK default
    atom37 = np.zeros((n, 37, 3), np.float32)
    mask = np.zeros((n, 37), np.float32)
    bfac = np.zeros((n, 37), np.float32)
    res_idx = np.zeros((n,), np.int32)
    ch_idx = np.zeros((n,), np.int32)
    for i, key in enumerate(order):
        r = residues[key]
        aatype[i] = rc.resname_to_idx.get(r["resname"], rc.restype_num)
        atom37[i] = r["pos"]
        mask[i] = r["mask"]
        bfac[i] = r["b"]
        res_idx[i] = key[1]
        ch_idx[i] = chain_ids.index(key[0])
    return ParsedProtein(aatype, atom37, mask, res_idx, ch_idx, bfac)


def parse_pdb(path: str) -> ParsedProtein:
    with open(path) as f:
        return parse_pdb_string(f.read())


def backbone_frames(atom37: np.ndarray, atom37_mask: np.ndarray):
    """AF2 backbone rigid group per residue -> (rigids7 (N, 7), exists (N,)).

    ``atom37_to_frames`` group 0 (data_transforms.py:766,839-846):
    from_3_points(p_neg_x_axis=C, origin=CA, p_xy_plane=N), then composed
    with the fixed rotation diag(-1, 1, -1). Float32 on the CPU."""
    pos = torch.as_tensor(np.asarray(atom37, np.float32))
    rot, trans = from_3_points(pos[..., rc.C_IDX, :], pos[..., rc.CA_IDX, :],
                               pos[..., rc.N_IDX, :])
    rot = rot @ torch.diag(torch.tensor([-1.0, 1.0, -1.0]))
    quat = rotmat_to_quat(rot)
    exists = (atom37_mask[..., rc.C_IDX] * atom37_mask[..., rc.CA_IDX]
              * atom37_mask[..., rc.N_IDX])
    return (torch.cat([quat, trans], -1).numpy().astype(np.float32),
            np.asarray(exists, np.float32))


@dataclasses.dataclass
class ProteinDatasetConfig:
    min_len: int = 20
    max_len: int = 512  # composition.yaml:56,66
    pad_to: Optional[int] = None  # pad/crop length; None = max over dataset
    center: bool = True  # CA-center each structure (reference processing)
    backbone_only_ok: bool = True  # accept structures missing side chains


class ProteinDataset:
    """Length-filtered PDB-backed dataset feeding the SE(3) trainer."""

    def __init__(self, paths: List[str], cfg: ProteinDatasetConfig = ProteinDatasetConfig()):
        self.cfg = cfg
        self.entries = []
        for p in paths:
            try:
                prot = parse_pdb(p)
            except Exception:
                continue
            rigids, exists = backbone_frames(prot.atom37, prot.atom37_mask)
            keep = exists > 0
            if keep.sum() < cfg.min_len or keep.sum() > cfg.max_len:
                continue
            rigids = rigids[keep]
            if cfg.center:
                rigids[:, 4:] -= rigids[:, 4:].mean(axis=0, keepdims=True)
            self.entries.append({
                "rigids_0": rigids,
                "seq_idx": np.arange(1, keep.sum() + 1, dtype=np.int32),
                "path": p,
                "aatype": prot.aatype[keep],
            })
        if not self.entries:
            raise ValueError("no parseable structures within length bounds")
        self.pad_to = cfg.pad_to or max(len(e["rigids_0"]) for e in self.entries)

    @staticmethod
    def from_dir(path: str, cfg: ProteinDatasetConfig = ProteinDatasetConfig()):
        paths = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith((".pdb", ".ent"))
        )
        return ProteinDataset(paths, cfg)

    def __len__(self):
        return len(self.entries)

    def batch(self, idxs) -> dict:
        """Pad-and-stack a training batch for ``make_se3_dsm_loss``."""
        n = self.pad_to
        b = len(idxs)
        rigids = np.zeros((b, n, 7), np.float32)
        rigids[..., 0] = 1.0  # identity quats in padding
        mask = np.zeros((b, n), np.float32)
        seq_idx = np.zeros((b, n), np.int32)
        for row, i in enumerate(idxs):
            e = self.entries[i]
            ln = min(len(e["rigids_0"]), n)
            rigids[row, :ln] = e["rigids_0"][:ln]
            mask[row, :ln] = 1.0
            seq_idx[row, :ln] = e["seq_idx"][:ln]
        return {"rigids_0": rigids, "res_mask": mask, "seq_idx": seq_idx}

    def epoch(self, rng: np.random.Generator, batch_size: int):
        """Shuffled batch iterator (one pass)."""
        perm = rng.permutation(len(self.entries))
        for i in range(0, len(perm) - batch_size + 1, batch_size):
            yield self.batch(perm[i : i + batch_size])
