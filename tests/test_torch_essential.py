"""The port's 5-point solver, pose decomposition, midpoint triangulation and
PnP RANSAC (mageslam_tpu_torch/geometry/essential.py, pnp.py) against the
JAX functions on the same seeded numpy inputs.

The 5-point solver's null-space basis comes from an SVD and is not unique:
torch's basis parametrizes the same solutions differently, so its grid
finds the roots in another order and, near a double root or the grid's
ends, another number of them. The solver is therefore held two ways:
- as a set: a sample's true E is its candidate that fits the epipolar
  constraint best over all 60 noise-free points, where that fit is within
  1e-3. Each side finds it on at least half of the 16 samples (measured:
  JAX 10, torch 12; the float32 grid misses it on the others, on either
  side), and where both find it, |<E_jax, E_torch>| >= 1 - 1e-3 (measured
  down to 1 - 2.6e-4). At least
  70 % of JAX's valid candidates have a torch match at >= 0.999 (the
  others are spurious roots, which die in RANSAC scoring);
- with JAX's basis injected: constraint coefficients within 1e-4 of the
  largest (float32 sums in another order; measured 5.1e-5). On JAX's
  coefficients the same valid roots but for at most 2 of the 160 (a
  determinant within float32 noise of 0 at a grid point; measured 1), and
  roots valid on both sides within 1e-3 relative. Through the whole solver
  (the port's own coefficients) at most 8 of the 160 validity flags differ
  (measured 5); a flip moves the later roots of its sample to other slots,
  so within each sample every JAX candidate but as many as flipped has a
  torch match with |<,>| >= 0.97 (an ill-conditioned spurious root measured
  0.982), the samples' true E >= 1 - 1e-3.
Decomposition: the four poses as a set, R and t within 1e-5 (SVD signs
differ; the set does not). Midpoint triangulation: within 1e-5 relative.
PnP RANSAC with the JAX key's draws injected: the same inliers, pose within
1e-4, same verdict; the unrefined DLT pose of 12 points within 1e-3 (float32
eigh of its 12×12 normal matrix; measured 2.0e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mageslam_tpu.geometry import essential as je
from mageslam_tpu.geometry import pnp as jpnp
from mageslam_tpu.geometry.se3 import Pose as JPose
from mageslam_tpu_torch.geometry import essential as te
from mageslam_tpu_torch.geometry import pnp as tpnp
from mageslam_tpu_torch.geometry.se3 import Pose

torch.set_num_threads(2)

N_POINTS = 60
N_SAMPLES = 16


def two_view(seed: int, n: int = N_POINTS, baseline=(0.5, 0.05, 0.02),
             euler=(0.03, -0.05, 0.01)):
    """Points in front of two cameras (as tests/test_essential_init.py's
    scene): (pts, R, t, n1, n2) with normalized coordinates n1, n2."""
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 9, n)], 1).astype(np.float32)
    a, b, c = euler
    Rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    Rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
    R = (Rz @ Ry @ Rx).astype(np.float32)
    t = (-R @ np.asarray(baseline, np.float32)).astype(np.float32)
    n1 = pts[:, :2] / pts[:, 2:3]
    Xc2 = pts @ R.T + t
    n2 = Xc2[:, :2] / Xc2[:, 2:3]
    return pts, R, t, n1.astype(np.float32), n2.astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    pts, R, t, n1, n2 = two_view(0)
    rng = np.random.RandomState(1)
    samples = np.stack([rng.choice(N_POINTS, 5, replace=False) for _ in range(N_SAMPLES)])
    p1, p2 = n1[samples], n2[samples]
    Ej, vj = (np.array(a) for a in jax.jit(je.five_point_essential)(jnp.asarray(p1),
                                                                     jnp.asarray(p2)))
    basis = np.array(jax.jit(je._null_space_4)(jnp.asarray(p1), jnp.asarray(p2)))
    return {"pts": pts, "R": R, "t": t, "n1": n1, "n2": n2, "p1": p1, "p2": p2,
            "E_jax": Ej, "valid_jax": vj, "basis": basis}


def _true_candidates(E, valid, n1, n2, tol=1e-3):
    """(B, R) bool: per sample, the valid candidate that fits the epipolar
    constraint p2ᵀ E p1 = 0 best over every point, where it fits within tol."""
    h1 = np.concatenate([n1, np.ones((len(n1), 1), np.float32)], 1)
    h2 = np.concatenate([n2, np.ones((len(n2), 1), np.float32)], 1)
    resid = np.where(valid, np.abs(np.einsum("mi,brij,mj->brm", h2, E, h1)).max(-1), np.inf)
    best = resid == resid.min(axis=1, keepdims=True)
    return best & (resid < tol)


def test_five_point_as_a_set(scene):
    Et, vt = (a.numpy() for a in te.five_point_essential(torch.from_numpy(scene["p1"]),
                                                         torch.from_numpy(scene["p2"])))
    Ej, vj = scene["E_jax"], scene["valid_jax"]
    assert Et.shape == Ej.shape and vt.shape == vj.shape
    np.testing.assert_allclose(np.linalg.norm(Et.reshape(N_SAMPLES, -1, 9), axis=-1)[vt],
                               1.0, atol=1e-5)
    dots = np.abs(np.einsum("brij,bqij->brq", Ej, Et))            # (B, R_jax, R_torch)
    best_t = np.where(vt[:, None, :], dots, 0).max(-1)           # per JAX candidate
    best_j = np.where(vj[:, :, None], dots, 0).max(-2)           # per torch candidate
    true_j = _true_candidates(Ej, vj, scene["n1"], scene["n2"])
    true_t = _true_candidates(Et, vt, scene["n1"], scene["n2"])
    found_j, found_t = true_j.any(axis=1), true_t.any(axis=1)
    assert found_j.sum() >= N_SAMPLES // 2 and found_t.sum() >= N_SAMPLES // 2
    both = found_j & found_t
    assert both.any()
    assert (best_t[true_j & both[:, None]] >= 1 - 1e-3).all()
    assert (best_j[true_t & both[:, None]] >= 1 - 1e-3).all()
    share = (best_t[vj] >= 0.999).mean()
    assert share >= 0.7, share


def test_five_point_with_the_reference_basis(scene):
    basis = scene["basis"]
    cj = np.array(jax.jit(je._constraint_coefficients)(jnp.asarray(basis)))
    ct = te.constraint_coefficients(torch.from_numpy(basis)).numpy()
    assert np.abs(ct - cj).max() <= 1e-4 * np.abs(cj).max()
    rj, rvj = (np.asarray(a) for a in jax.jit(je._find_real_roots)(jnp.asarray(cj)))
    rt, rvt = (a.numpy() for a in te.find_real_roots(torch.from_numpy(cj)))
    assert (rvt != rvj).sum() <= 2
    both = rvt & rvj
    rel = np.abs(rt - rj) / np.maximum(np.abs(rj), 1.0)
    assert rel[both].max() <= 1e-3, rel[both].max()
    Et, vt = (a.numpy() for a in te.five_point_essential(
        torch.from_numpy(scene["p1"]), torch.from_numpy(scene["p2"]),
        basis=torch.from_numpy(basis)))
    Ej, vj = scene["E_jax"], scene["valid_jax"]
    flips = int((vt != vj).sum())
    assert flips <= 8
    # a flip shifts the later roots' slots: match within each sample
    dots = np.abs(np.einsum("brij,bqij->brq", Ej, Et))
    best = np.where(vt[:, None, :], dots, 0).max(-1)
    assert (best[vj] < 0.97).sum() <= flips, np.sort(best[vj])[:flips + 1]
    true = _true_candidates(Ej, vj, scene["n1"], scene["n2"])
    assert true.any() and (best[true] >= 1 - 1e-3).all(), best[true].min()


def test_grid_matches_the_reference():
    u = jnp.linspace(-jnp.pi / 2 + 1e-3, jnp.pi / 2 - 1e-3, je.GRID_SIZE)
    want = np.asarray(jnp.tan(u))
    np.testing.assert_allclose(te.grid(), want, rtol=5e-5)
    assert (np.diff(te.grid()) > 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_decompose_essential_as_a_set(seed):
    _, R, t, _, _ = two_view(seed, euler=(0.03 * seed, -0.05, 0.01 + 0.02 * seed))
    E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32) @ R
    E = (E / np.linalg.norm(E)).astype(np.float32)
    pj = je.decompose_essential(jnp.asarray(E))
    pt = te.decompose_essential(torch.from_numpy(E))
    Rj, tj = np.asarray(pj.R), np.asarray(pj.t)
    Rt, tt = pt.R.numpy(), pt.t.numpy()
    for i in range(4):
        d = [max(np.abs(Rt[k] - Rj[i]).max(), np.abs(tt[k] - tj[i]).max()) for k in range(4)]
        assert min(d) <= 1e-5, (i, d)
    # the true pose is among them, in both
    t_dir = t / np.linalg.norm(t)
    assert any(np.abs(Rt[k] - R).max() < 1e-4 and np.abs(tt[k] - t_dir).max() < 1e-4
               for k in range(4))


def test_triangulate_midpoint_pair():
    pts, R, t, n1, n2 = two_view(2)
    xj = np.asarray(je.triangulate_midpoint_pair(JPose(jnp.asarray(R), jnp.asarray(t)),
                                                 jnp.asarray(n1), jnp.asarray(n2)))
    xt = te.triangulate_midpoint_pair(Pose(torch.from_numpy(R), torch.from_numpy(t)),
                                      torch.from_numpy(n1), torch.from_numpy(n2)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt, pts, rtol=1e-3, atol=1e-3)


def jax_pnp_draws(key, hypotheses: int, m: int) -> np.ndarray:
    """The Gumbel draws pnp_ransac makes from `key` (one row a hypothesis)."""
    keys = jax.random.split(key, hypotheses)
    return np.array(jax.vmap(lambda k: jax.random.gumbel(k, (m,)))(keys), np.float32)


@pytest.mark.parametrize("outliers", [0, 25])
def test_pnp_ransac_with_injected_draws(outliers):
    rng = np.random.RandomState(3 + outliers)
    pts, R, t, _, _ = two_view(4, n=100)
    cam = np.array([300.0, 300.0, 160.0, 120.0], np.float32)
    Xc = pts @ R.T + t
    uv = (cam[:2] * Xc[:, :2] / Xc[:, 2:3] + cam[2:]).astype(np.float32)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    bad = rng.choice(100, outliers, replace=False)
    uv[bad] = rng.uniform(0, 300, (outliers, 2)).astype(np.float32)
    valid = rng.rand(100) < 0.9
    key = jax.random.PRNGKey(11 + outliers)
    rj = jpnp.pnp_ransac(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid),
                         jnp.asarray(cam), key, max_reprojection_error=4.0, min_inliers=10,
                         hypotheses=64)
    draws = torch.from_numpy(jax_pnp_draws(key, 64, 100))
    rt = tpnp.pnp_ransac(torch.from_numpy(pts), torch.from_numpy(uv),
                         torch.from_numpy(valid), torch.from_numpy(cam), draws,
                         max_reprojection_error=4.0, min_inliers=10)
    assert bool(rt.ok) == bool(rj.ok) and bool(rt.ok)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.num_inliers) == int(rj.num_inliers)
    np.testing.assert_allclose(rt.pose.R.numpy(), np.asarray(rj.pose.R), atol=1e-4)
    np.testing.assert_allclose(rt.pose.t.numpy(), np.asarray(rj.pose.t), atol=1e-4)
    np.testing.assert_allclose(rt.pose.R.numpy(), R, atol=5e-3)


def test_dlt_pose_matches_the_reference():
    pts, R, t, n1, n2 = two_view(5, n=12)
    pj = jax.jit(jpnp._dlt_pose)(jnp.asarray(pts), jnp.asarray(n2))
    pt = tpnp.dlt_pose(torch.from_numpy(pts), torch.from_numpy(n2))
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=1e-3)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=1e-3)
    np.testing.assert_allclose(pt.R.numpy(), R, atol=1e-2)
