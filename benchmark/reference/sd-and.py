"""Plain reference of the SuperDiff AND composition on an SD-1.x reference's
modules: Euler-Maruyama steps on the sigma grid with classifier-free
guidance, and the closed-form kappa of the paper that makes the two
prompts' log-likelihood increments equal (up to the lift), written out from
the paper's estimator. It imports nothing of the program under test; the
modules, the text encoding and the sigma grid come from the configuration's
reference (``ref``, e.g. ``sd-v1-4.py``), the sampler's arithmetic stays
float32.

With v_a, v_b the two prompts' velocities, v_u the unconditional one, g
the guidance scale and dx_b = 2 dsigma (v_u + g (v_b - v_u)) + noise the
step prompt b alone would take, the Ito increment of prompt i's
log-density over a step dx is

    dll_i = sum(-|dsigma| / sigma * v_i^2 - dx * v_i / sigma),

and the step dx = 2 dsigma (v_u + g ((v_b - v_u) + kappa (v_a - v_b))) +
noise is affine in kappa, so dll_a - dll_b = -lift / N (N steps) solves
in closed form:

    kappa = [ |dsigma| sum((v_b - v_a)(v_b + v_a)) - sum(dx_b (v_a - v_b))
              + sigma * lift / N ] / [ 2 dsigma g sum((v_a - v_b)^2) ].
"""

from __future__ import annotations

import torch


@torch.no_grad()
def sample_and(ref, m: dict, config: dict, obj: str, bg: str, x_T: torch.Tensor,
               zs: torch.Tensor, method: dict):
    """The AND composition of ``obj`` and ``bg`` from the unit normals
    ``x_T`` (B, h, w, 4) and ``zs`` (steps, B, h, w, 4) with ``method``'s
    ``guidance_scale`` and ``lift``. Returns (latents (B, h, w, 4), kappa
    (steps, B), ll (steps, B, 2)), float32."""
    dev, b = x_T.device, x_T.shape[0]
    steps = zs.shape[0]
    g, lift = method["guidance_scale"], method["lift"]
    ctx = torch.cat([ref.encode(m["text"], [p] * b, config, dev) for p in (obj, bg, "")])
    ts, sig, init = ref.sigma_grid(steps)
    ts, sig = torch.tensor(ts, dtype=torch.float32), torch.tensor(sig, dtype=torch.float32)
    x = x_T.float() * init
    ll = torch.ones((b, 2), dtype=torch.float32, device=dev)
    kappas, lls = [], []
    for i in range(steps):
        sigma, dsigma = sig[i].to(dev), (sig[i + 1] - sig[i]).to(dev)
        v = m["unet"](x / torch.sqrt(sigma**2 + 1.0), ts[i].to(dev), ctx).reshape(3, b, -1)
        v_a, v_b, v_u = v.unbind(0)
        noise = torch.sqrt(2.0 * dsigma.abs() * sigma) * zs[i].reshape(b, -1)
        dx_b = 2.0 * dsigma * (v_u + g * (v_b - v_u)) + noise
        d = v_a - v_b
        num = dsigma.abs() * ((v_b - v_a) * (v_b + v_a)).sum(-1) - (dx_b * d).sum(-1)
        kappa = (num + sigma * lift / steps) / (2.0 * dsigma * g * (d * d).sum(-1))
        dx = 2.0 * dsigma * (v_u + g * ((v_b - v_u) + kappa[:, None] * d)) + noise
        dll = (-dsigma.abs() / sigma * v[:2] ** 2 - dx[None] * v[:2] / sigma).sum(-1)
        x = x + dx.reshape(x.shape)
        ll = ll + dll.T
        kappas.append(kappa)
        lls.append(ll)
    return x, torch.stack(kappas), torch.stack(lls)
