"""Port SE(3) geometry (rigid algebra, R^3 / IGSO(3) / SE(3) diffusers,
backbone atoms and PDB text, the protein Itô and kappa forms) vs the JAX
package, fp32 on the CPU. Inputs are numpy draws from fixed seeds; the
JAX side runs eagerly (each case is a handful of ops). Tolerance: 1e-6 of
the largest reference value (fp32 rounding of a few chained ops), unless a
case says otherwise; table rows and grid indices are held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from superdiff_tpu.core import ito as jito
from superdiff_tpu.core import kappa as jkappa
from superdiff_tpu.models.protein import backbone as jbackbone
from superdiff_tpu.models.protein import rigid as jrigid
from superdiff_tpu.models.protein.r3 import R3Diffuser as JR3
from superdiff_tpu.models.protein.se3 import SE3Diffuser as JSE3
from superdiff_tpu.models.protein.so3 import SO3Diffuser as JSO3
from superdiff_tpu.pipelines import protein as jprotein
from superdiff_tpu_torch.core import ito, kappa
from superdiff_tpu_torch.models.protein import backbone, rigid
from superdiff_tpu_torch.models.protein.r3 import R3Diffuser
from superdiff_tpu_torch.models.protein.se3 import SE3Diffuser
from superdiff_tpu_torch.models.protein.so3 import SO3Diffuser

torch.set_num_threads(1)
TABLES = dict(num_sigma=100, num_omega=200, L=200)  # the protein golden's sizes


def close(got, ref, tol=1e-6):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} x {scale}"


@pytest.fixture(scope="module")
def so3s():
    return JSO3(**TABLES), SO3Diffuser(**TABLES, device="cpu")


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotvecs(rng, n):
    """Random rotation vectors with the corner cases: zero, below the
    Rodrigues Taylor threshold, and angles near pi."""
    v = rng.standard_normal((n, 3)).astype(np.float32)
    v[0] = 0.0
    v[1] = [3e-5, -2e-5, 1e-5]
    axis = v[2:5] / np.linalg.norm(v[2:5], axis=-1, keepdims=True)
    v[2:5] = axis * np.float32([np.pi - 1e-3, np.pi - 0.05, 3.0])[:, None]
    return v


# rigid ----------------------------------------------------------------------

RIGID_CASES = {
    "quat_to_rotmat": lambda r: (r["q"],),
    "rotmat_to_quat": lambda r: (r["m"],),
    "rotvec_to_rotmat": lambda r: (r["v"],),
    "rotmat_to_rotvec": lambda r: (r["m"],),
    "rotvec_compose": lambda r: (r["v"], r["v2"]),
    "quat_multiply": lambda r: (r["q"], r["q2"]),
    "project_rotmat": lambda r: (r["m_noisy"],),
    "rigid": lambda r: (r["q_raw"], r["x"]),
    "rigid_apply": lambda r: (r["r7"], r["x"]),
    "rigid_compose_rotvec": lambda r: (r["r7"], r["v"], r["x"]),
    "rigid_compose_q_update": lambda r: (r["r7"], r["upd"], r["mask"]),
}


@pytest.fixture(scope="module")
def rigid_inputs():
    rng = np.random.default_rng(0)
    n = 64
    q = _quats(rng, n)
    v = _rotvecs(rng, n)
    # rotation matrices from the rotvecs (near-pi ones exercise every
    # branch of the four-candidate quaternion), plus exact identity and
    # 180-degree turns about each axis
    m = np.array(jax.jit(jrigid.rotvec_to_rotmat)(jnp.asarray(v)))
    m[5] = np.eye(3)
    m[6:9] = [np.diag(d).astype(np.float32) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])]
    q_raw = rng.standard_normal((n, 4)).astype(np.float32)
    r7 = np.concatenate([q, 5 * rng.standard_normal((n, 3)).astype(np.float32)], -1)
    return {
        "q": q, "q2": _quats(rng, n), "q_raw": q_raw, "v": v,
        "v2": _rotvecs(rng, n)[::-1].copy(), "m": m,
        "m_noisy": m + 0.01 * rng.standard_normal(m.shape).astype(np.float32),
        "x": rng.standard_normal((n, 3)).astype(np.float32), "r7": r7,
        "upd": 0.3 * rng.standard_normal((n, 6)).astype(np.float32),
        "mask": (rng.random((n, 1)) > 0.3).astype(np.float32),
    }


@pytest.mark.parametrize("name", sorted(RIGID_CASES))
def test_rigid_matches_jax(name, rigid_inputs):
    args = RIGID_CASES[name](rigid_inputs)
    ref = jax.jit(getattr(jrigid, name))(*map(jnp.asarray, args))
    got = getattr(rigid, name)(*map(t, args))
    # near-pi logs amplify the rotmat's rounding: one fp32 ulp of the matrix
    # moves the angle by ~1e-4 at pi - 1e-3
    close(got, ref, 3e-4 if name == "rotmat_to_rotvec" else 2e-6)


def test_rigid_identity_and_scale_trans():
    got = rigid.rigid_identity((2, 3), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrigid.rigid_identity((2, 3))))
    r7 = torch.randn(2, 3, 7)
    s = rigid.scale_trans(r7, 0.1)
    np.testing.assert_array_equal(s[..., :4].numpy(), r7[..., :4].numpy())
    np.testing.assert_array_equal(s[..., 4:].numpy(), (r7[..., 4:] * 0.1).numpy())


# R^3 ------------------------------------------------------------------------

@pytest.mark.parametrize("tt", [0.002, 0.37, 1.0])
def test_r3_matches_jax(tt):
    rng = np.random.default_rng(1)
    x_t, x_0, score, z = (rng.standard_normal((2, 9, 3)).astype(np.float32) for _ in range(4))
    jr, pr = JR3(), R3Diffuser()
    tj, tp = jnp.float32(tt), torch.tensor(tt, dtype=torch.float32)
    for name in ("b_t", "marginal_b_t", "diffusion_coef", "conditional_var", "score_scaling"):
        close(getattr(pr, name)(tp), getattr(jr, name)(tj))
    close(pr.drift_coef(t(x_t), tp), jr.drift_coef(jnp.asarray(x_t), tj))
    close(pr.score(t(x_t), t(x_0), tp), jr.score(jnp.asarray(x_t), jnp.asarray(x_0), tj),
          1e-5)
    close(pr.calc_trans_score(t(x_t), t(x_0), tp),
          jr.calc_trans_score(jnp.asarray(x_t), jnp.asarray(x_0), tj), 1e-5)
    dt = np.float32(1 / 500)
    for stochastic in (False, True):
        key = jax.random.PRNGKey(3)
        ref = jr.reverse_perturbation(key, jnp.asarray(x_t), jnp.asarray(score), tj, dt,
                                      stochastic=stochastic, noise_scale=0.1)
        z = np.asarray(jax.random.normal(key, score.shape))  # JAX's draw, replayed
        got = pr.reverse_perturbation(t(x_t), t(score), tp, torch.tensor(dt),
                                      stochastic=stochastic, noise_scale=0.1, z=t(z))
        close(got, ref)


# IGSO(3) --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["omegas", "sigmas", "cdf", "score_scaling_table"])
def test_so3_tables_equal_jax(name, so3s):
    j, p = so3s
    np.testing.assert_array_equal(getattr(p, name).numpy(), np.asarray(getattr(j.tables, name)))


def test_so3_score_norm_table_matches_jax(so3s):
    # summed over l by a matrix product: float64 rounding, then one fp32 ulp
    j, p = so3s
    close(p.score_norm, j.tables.score_norm, 1e-6)


@pytest.mark.parametrize("steps", [5, 50, 500])
def test_so3_t_to_idx_matches_jax_on_composition_schedules(so3s, steps):
    """The table rows picked at every t of a composition's schedule equal
    those of JAX's jitted lookup (as ``compose`` runs it); sigma(t) within
    1e-6 (XLA contracts ``t e^smax + (1-t) e^smin`` into an FMA, and its log
    differs from PyTorch's in the last bits)."""
    j, p = so3s
    ts = np.linspace(0.002, 1.0, steps)[::-1].astype(np.float32)
    np.testing.assert_array_equal(p.t_to_idx(t(ts)).numpy(),
                                  np.asarray(jax.jit(j.t_to_idx)(jnp.asarray(ts))))
    close(p.sigma(t(ts)), jax.jit(j.sigma)(jnp.asarray(ts)), 1e-6)
    close(p.diffusion_coef(t(ts)), j.diffusion_coef(jnp.asarray(ts)))
    assert int(p.t_to_idx(1.0)) == int(j.t_to_idx(jnp.float32(1.0))) == TABLES["num_sigma"] - 1


def test_so3_t_to_idx_at_grid_edges(so3s):
    """At t exactly on the sigma grid (and one ulp either side) one ulp of
    sigma picks another row: the port's row is searchsorted(right) of its
    own sigma, and it differs from JAX's only where the two sigmas sit
    within two ulps of that grid edge."""
    j, p = so3s
    ts = np.linspace(0.0, 1.0, TABLES["num_sigma"]).astype(np.float32)
    ts = np.concatenate([ts, np.nextafter(ts, np.float32(2)), np.nextafter(ts, np.float32(-1))])
    ts = ts.clip(0, 1)
    grid = p.sigmas.numpy()
    s_p = p.sigma(t(ts)).numpy()
    idx_p = p.t_to_idx(t(ts)).numpy()
    np.testing.assert_array_equal(idx_p, np.clip(np.searchsorted(grid, s_p, "right") - 1, 0,
                                                 len(grid) - 1))
    idx_j = np.asarray(jax.jit(j.t_to_idx)(jnp.asarray(ts)))
    differ = idx_p != idx_j
    assert differ.mean() < 0.1
    edge = grid[np.maximum(idx_p, idx_j)[differ]]
    np.testing.assert_array_max_ulp(s_p[differ], edge, maxulp=2)
    assert (np.abs(idx_p - idx_j) <= 1).all()


@pytest.mark.parametrize("per_batch", [False, True])
def test_so3_score_matches_jax(so3s, per_batch):
    j, p = so3s
    rng = np.random.default_rng(2)
    v = _rotvecs(rng, 24).reshape(2, 12, 3)
    if per_batch:
        tt = np.float32([[0.05], [0.9]])
    else:
        tt = np.float32(0.31)
    ref = jax.jit(j.score)(jnp.asarray(v), jnp.asarray(tt))
    got = p.score(t(v), t(tt))
    close(got, ref, 2e-6)
    close(p.score_scaling(t(tt)), j.score_scaling(jnp.asarray(tt)))


@pytest.mark.parametrize("tt", [1.0, 0.4])
def test_so3_sample_on_injected_draws_matches_jax(so3s, tt):
    j, p = so3s
    key = jax.random.PRNGKey(11)
    shape = (3, 17)
    ref = jax.jit(j.sample, static_argnums=2)(key, jnp.float32(tt), shape)
    k1, k2 = jax.random.split(key)  # JAX's draws, replayed
    axis = np.asarray(jax.random.normal(k1, shape + (3,)))
    u = np.asarray(jax.random.uniform(k2, shape))
    got = p.sample(tt, shape, axis=t(axis), u=t(u))
    close(got, ref, 2e-6)
    if tt == 1.0:
        close(p.sample_ref(shape, axis=t(axis), u=t(u)), j.sample_ref(key, shape), 2e-6)


def test_so3_reverse_perturbation_matches_jax(so3s):
    j, p = so3s
    rng = np.random.default_rng(4)
    score = rng.standard_normal((2, 8, 3)).astype(np.float32)
    dt = np.float32(0.002)
    for stochastic in (False, True):
        key = jax.random.PRNGKey(5)
        ref = j.reverse_perturbation(key, jnp.asarray(score), jnp.float32(0.6), dt,
                                     stochastic=stochastic, noise_scale=0.5)
        z = np.asarray(jax.random.normal(key, score.shape))
        got = p.reverse_perturbation(t(score), torch.tensor(0.6), torch.tensor(dt),
                                     stochastic=stochastic, noise_scale=0.5, z=t(z))
        close(got, ref)


# SE(3) ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def se3s(so3s):
    return JSE3(r3=JR3(), so3=so3s[0]), SE3Diffuser(r3=R3Diffuser(), so3=so3s[1])


@pytest.mark.parametrize("masked,center", [(False, True), (True, True), (True, False)])
def test_se3_reverse_with_external_dx_matches_jax(se3s, masked, center):
    j, p = se3s
    rng = np.random.default_rng(6)
    r7 = np.concatenate([_quats(rng, 20), 8 * rng.standard_normal((20, 3))], -1)
    r7 = r7.astype(np.float32).reshape(2, 10, 7)
    rot_s, tr_s, dx_t, dx_r = (0.2 * rng.standard_normal((2, 10, 3)).astype(np.float32)
                               for _ in range(4))
    mask = (rng.random((2, 10)) > 0.25).astype(np.float32) if masked else None
    kw = dict(stochastic=False, noise_scale=0.1, center=center)
    reverse = jax.jit(lambda *a, **k: j.reverse(*a, **k, **kw))
    ref = reverse(jax.random.PRNGKey(0), jnp.asarray(r7), jnp.asarray(rot_s),
                  jnp.asarray(tr_s), jnp.float32(0.5), jnp.float32(0.002),
                  diffuse_mask=None if mask is None else jnp.asarray(mask),
                  dx_trans=jnp.asarray(dx_t), dx_rots=jnp.asarray(dx_r))
    got = p.reverse(t(r7), t(rot_s), t(tr_s), torch.tensor(0.5), torch.tensor(0.002),
                    diffuse_mask=None if mask is None else t(mask), dx_trans=t(dx_t),
                    dx_rots=t(dx_r), **kw)
    close(got, ref, 2e-6)
    # the internal (deterministic) EM step
    ref = reverse(jax.random.PRNGKey(0), jnp.asarray(r7), jnp.asarray(rot_s),
                  jnp.asarray(tr_s), jnp.float32(0.5), jnp.float32(0.002))
    got = p.reverse(t(r7), t(rot_s), t(tr_s), torch.tensor(0.5), torch.tensor(0.002), **kw)
    close(got, ref, 2e-6)


def test_se3_calc_scores_match_jax(se3s):
    j, p = se3s
    rng = np.random.default_rng(7)
    m0, m1 = (rigid.quat_to_rotmat(t(_quats(rng, 16))).reshape(2, 8, 3, 3).numpy()
              for _ in range(2))
    tt = np.float32([[0.2], [0.7]])
    close(p.calc_rot_score(t(m0), t(m1), t(tt)),
          jax.jit(j.calc_rot_score)(jnp.asarray(m0), jnp.asarray(m1), jnp.asarray(tt)), 1e-5)
    x0, x1 = (rng.standard_normal((2, 8, 3)).astype(np.float32) for _ in range(2))
    close(p.calc_trans_score(t(x0), t(x1), t(tt[..., None])),
          j.calc_trans_score(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(tt[..., None])), 1e-5)


def test_se3_sample_ref_is_unit_rigids(se3s):
    _, p = se3s
    r = p.sample_ref(7, 3, generator=torch.Generator().manual_seed(0))
    assert r.shape == (3, 7, 7) and torch.isfinite(r).all()
    torch.testing.assert_close(r[..., :4].norm(dim=-1), torch.ones(3, 7))
    assert (r[..., 0] >= 0).all()


# backbone -------------------------------------------------------------------

@pytest.mark.parametrize("with_psi", [False, True])
def test_to_atom37_matches_jax(with_psi):
    rng = np.random.default_rng(8)
    r7 = np.concatenate([_quats(rng, 12), 10 * rng.standard_normal((12, 3))], -1)
    r7 = r7.astype(np.float32).reshape(2, 6, 7)
    psi = rng.standard_normal((2, 6, 2)).astype(np.float32) if with_psi else None
    ref = jax.jit(jbackbone.to_atom37)(jnp.asarray(r7), None if psi is None else jnp.asarray(psi))
    got = backbone.to_atom37(t(r7), None if psi is None else t(psi))
    close(got, ref, 2e-6)


def test_to_pdb_text_matches_jax():
    rng = np.random.default_rng(9)
    r7 = np.concatenate([_quats(rng, 9), 10 * rng.standard_normal((9, 3))], -1)
    r7 = r7.astype(np.float32)
    atoms = backbone.to_atom37(t(r7)).numpy()
    aatype = np.arange(9) % 20
    aatype[3] = 7  # GLY: no CB record
    mask = np.ones(9)
    mask[5] = 0
    bf = rng.random(9)
    ref = jbackbone.to_pdb(atoms, aatype=aatype, res_mask=mask, b_factors=bf, chain="B")
    assert backbone.to_pdb(atoms, aatype=aatype, res_mask=mask, b_factors=bf,
                           chain="B") == ref
    assert backbone.to_pdb(torch.from_numpy(atoms.copy())) == jbackbone.to_pdb(atoms)
    assert backbone.to_pdb(backbone.to_atom37(t(r7))).count("ATOM") == 9 * 5


# Itô and kappa forms ----------------------------------------------------------

def _scores(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 3, 10, 3), (3, 10, 3), (3, 10, 3), (3, 10, 3))]


def test_dlogq_sde_r3_matches_jax():
    scores, x, dx, f_x = _scores(10)
    args = (np.float32(2.3), np.float32(-1.15), np.float32(0.002))
    ref = jito.dlogq_sde_r3(*map(jnp.asarray, (scores, x, dx, f_x)), *args)
    got = ito.dlogq_sde_r3(*map(t, (scores, x, dx, f_x)), *map(torch.tensor, args))
    assert got.shape == (3, 2)
    close(got, ref, 1e-6)


def test_dlogq_sde_driftless_matches_jax():
    scores, _, dx, _ = _scores(11)
    ref = jito.dlogq_sde_driftless(jnp.asarray(scores), jnp.asarray(dx), np.float32(1.7),
                                   np.float32(0.002))
    got = ito.dlogq_sde_driftless(t(scores), t(dx), torch.tensor(1.7), torch.tensor(0.002))
    close(got, ref, 1e-6)


@pytest.mark.parametrize("drift,lift", [(True, False), (False, True)])
def test_kappa_and_generic_matches_jax(drift, lift):
    scores, dx_ind, f_x, _ = _scores(12)
    f = f_x if drift else np.float32(0.0)
    kw = dict(num_steps=500, logp=0.4, sigma_weight=np.float32(0.3) if lift else None)
    ref = jkappa.kappa_and_generic(jnp.asarray(scores[0]), jnp.asarray(scores[1]),
                                   jnp.asarray(dx_ind), jnp.asarray(f), np.float32(2.1),
                                   np.float32(0.002), **kw)
    kw["sigma_weight"] = None if not lift else torch.tensor(0.3)
    got = kappa.kappa_and_generic(t(scores[0]), t(scores[1]), t(dx_ind), t(np.asarray(f)),
                                  torch.tensor(2.1), torch.tensor(0.002), **kw)
    close(got, ref, 1e-5)


def test_kappa_and_generic_matches_the_jax_composition_with_equal_scores():
    """Batch row 1 has model b's score equal to model a's (a zero
    denominator): 0.5 there, as JAX's composition ``_kappa_and`` gives; row
    0 is the ordinary closed form with the lift."""
    scores, dx_ind, f_x, _ = _scores(13)
    a, b = scores[0][:2], scores[1][:2].copy()
    b[1] = a[1]
    beta, dt, w = np.float32(2.1), np.float32(0.002), np.float32(0.3)
    ref = jprotein._kappa_and(jnp.asarray(a), jnp.asarray(b), jnp.asarray(dx_ind[:2]),
                              jnp.asarray(f_x[:2]), beta, dt, 0.4 * w / 500)
    got = kappa.kappa_and_generic(t(a), t(b), t(dx_ind[:2]), t(f_x[:2]), torch.tensor(beta),
                                  torch.tensor(dt), 500, 0.4, torch.tensor(w))
    assert float(np.asarray(ref)[1]) == 0.5
    close(got, ref, 1e-5)


def test_normalized_log_sigma_matches_jax():
    s = np.linspace(0.1, 1.5, 11).astype(np.float32)
    ref = jkappa.normalized_log_sigma(jnp.asarray(s), 0.1, 1.5, 36)
    close(kappa.normalized_log_sigma(t(s), 0.1, 1.5, 36), ref, 1e-6)
    rs = np.sqrt(np.float32([0.1, 20.0]))
    ref = jkappa.normalized_log_sigma(jnp.asarray(s), jnp.sqrt(0.1), jnp.sqrt(20.0), 9)
    close(kappa.normalized_log_sigma(t(s), torch.tensor(rs[0]), torch.tensor(rs[1]), 9), ref)
