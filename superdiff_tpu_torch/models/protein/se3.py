"""SE(3) diffuser: R^3 translations x IGSO(3) rotations (port of
``superdiff_tpu/models/protein/se3.py``).

Reference noise rigids, score scaling, and the reverse step with the
external-``dx`` seam that SuperDiff drives. Rigids use the tensor-7 layout
of ``rigid.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import rigid
from .r3 import R3Diffuser
from .so3 import SO3Diffuser


@dataclasses.dataclass(frozen=True)
class SE3Diffuser:
    r3: R3Diffuser
    so3: SO3Diffuser

    @staticmethod
    def default(device="cuda") -> "SE3Diffuser":
        """The composition's diffuser: full IGSO(3) tables (1000 sigmas x
        1000 omegas, 1000 series terms) on ``device``."""
        return SE3Diffuser(r3=R3Diffuser(), so3=SO3Diffuser(device=device))

    @property
    def device(self):
        return self.so3.device

    def to(self, device) -> "SE3Diffuser":
        """A copy whose IGSO(3) tables live on ``device``."""
        return dataclasses.replace(self, so3=self.so3.to(device))

    def score_scaling(self, t) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.so3.score_scaling(t), self.r3.score_scaling(t)

    def sample_ref(self, n_res: int, batch: int = 1,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Reference (t=1) noise rigids: IGSO3(1) rotations + N(0, I) scaled
        translations, drawn from ``generator``."""
        rotvec = self.so3.sample_ref((batch, n_res), generator=generator)
        quat = rigid.rotmat_to_quat(rigid.rotvec_to_rotmat(rotvec))
        trans = self.r3.unscale(self.r3.sample_ref((batch, n_res), generator=generator,
                                                   device=self.device))
        return rigid.rigid(quat, trans)

    def calc_trans_score(self, trans_t, trans_0, t):
        return self.r3.calc_trans_score(trans_t, trans_0, t)

    def calc_rot_score(self, rotmats_t, rotmats_0, t) -> torch.Tensor:
        """IGSO3 score at the relative rotation R_t^T R_0 (the FrameDiff
        convention)."""
        rel = rotmats_t.transpose(-1, -2) @ rotmats_0
        return self.so3.score(rigid.rotmat_to_rotvec(rel), t)

    def reverse(
        self,
        rigids_t: torch.Tensor,  # (..., 7)
        rot_score: torch.Tensor,  # (..., 3)
        trans_score: torch.Tensor,  # (..., 3) in scaled coordinates
        t,
        dt,
        *,
        stochastic: bool = False,
        noise_scale: float = 1.0,
        diffuse_mask: Optional[torch.Tensor] = None,
        center: bool = True,
        dx_trans: Optional[torch.Tensor] = None,  # externally supplied EM steps
        dx_rots: Optional[torch.Tensor] = None,  # (the SuperDiff seam)
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """One reverse step on SE(3); an external dx overrides the internal
        EM step of its component. With ``dx_trans`` the translation update is
        ``x + dx``, without it ``x - perturb``; rotations compose on the
        right by the tangent update. A stochastic internal step draws its
        noise from ``generator``."""
        trans_t = self.r3.scale(rigid.rigid_trans(rigids_t))
        if dx_trans is not None:
            trans_pert = dx_trans
        else:
            trans_pert = -self.r3.reverse_perturbation(
                trans_t, trans_score, t, dt, stochastic=stochastic,
                noise_scale=noise_scale, generator=generator)
        if dx_rots is not None:
            rot_pert = dx_rots
        else:
            rot_pert = self.so3.reverse_perturbation(
                rot_score, t, dt, stochastic=stochastic, noise_scale=noise_scale,
                generator=generator)

        if diffuse_mask is not None:
            trans_pert = trans_pert * diffuse_mask[..., None]
            rot_pert = rot_pert * diffuse_mask[..., None]

        new_trans = trans_t + trans_pert
        if center:
            if diffuse_mask is None:
                com = new_trans.mean(dim=-2, keepdim=True)
            else:
                w = diffuse_mask[..., None]
                com = (new_trans * w).sum(dim=-2, keepdim=True) / torch.clamp_min(
                    w.sum(dim=-2, keepdim=True), 1.0)
            new_trans = new_trans - com
        new_trans = self.r3.unscale(new_trans)

        rotmat = rigid.rigid_rotmat(rigids_t) @ rigid.rotvec_to_rotmat(rot_pert)
        return rigid.rigid(rigid.rotmat_to_quat(rotmat), new_trans)
