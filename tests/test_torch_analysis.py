"""The port's offline analysis (mageslam_tpu_torch/analysis: clouds, volume
of interest) and its FossilizedMap and live queries, held against the JAX
package's on the CPU.

- At N = 256 points (a noisy plane, a noisy sphere, a box and a lattice
  with exact ties, some slots invalid): `knn` indices exact (ties to the lower index, as
  `jax.lax.top_k`) and distances within 1e-6; normals as |n·n'| within
  1e-5 (an eigenvector's sign is the solver's choice), and JAX's within
  1e-5 once aligned to a previous normal; `mollify_normals` and
  `compute_characteristics` on the same inputs within 1e-5 relative;
  `reposition_points` on the plane within 2e-5 of the cloud's extent given
  JAX's normal signs (numpy's LAPACK solver patched in) and within 2e-3
  with torch's own (the mollification depends on the signs: ROADMAP queue
  3).
- The volume of interest on a ring of inward-looking cameras and on random
  poses: the teardrop scores within 1e-5 relative, the box within 1e-5.
- `FossilizedMap` live against JAX's at N = 256 point slots (the end state
  below, its first 256 slots). On the JAX photoreal session's end state
  (the photoreal fixture's map and tests/data/torch_port_vi.npz's `pr_*`):
  `FossilizedMap`'s
  trajectory, tracking results, raw cloud, the denoised cloud (to the
  same two tolerances) and volume of interest, and the live `get_tracking_results_for_frames` /
  `try_get_volume_of_interest`, against the JAX answers stored there.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.analysis import clouds as jc
from mageslam_tpu.analysis import voi as jv
from mageslam_tpu.geometry.se3 import Pose as JPose
from mageslam_tpu_torch import SlamSession, golden_path_settings, interop
from mageslam_tpu_torch.analysis import clouds as pc
from mageslam_tpu_torch.analysis import voi as pv
from mageslam_tpu_torch.geometry.se3 import Pose, quat_to_rot
from mageslam_tpu_torch.runtime.fossilized import FossilizedMap
from mageslam_tpu_torch.runtime.pose_history import PoseHistory
from mageslam_tpu_torch.worldmap.map_state import MapState

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHOTOREAL = os.path.join(REPO, "tests", "data", "torch_port_photoreal.npz")
VI_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_vi.npz")
N = 256
K = 8
ATOL = 1e-5
SAME_SIGN_ATOL = 2e-5         # of the cloud's extent, with JAX's normal signs
REPOSITION_SIGN_ATOL = 2e-3   # of the cloud's extent, with torch's own signs


def cloud(kind: str) -> tuple[np.ndarray, np.ndarray]:
    """(N, 3) float32 points and an (N,) validity mask."""
    rng = np.random.default_rng({"plane": 0, "box": 1, "lattice": 2, "sphere": 3}[kind])
    if kind == "plane":
        pts = np.stack([rng.uniform(-1, 1, N), rng.uniform(-1, 1, N),
                        0.3 + rng.normal(0, 0.01, N)], 1)
    elif kind == "sphere":
        d = rng.normal(size=(N, 3))
        pts = d / np.linalg.norm(d, axis=1, keepdims=True) + rng.normal(0, 0.005, (N, 3))
    elif kind == "box":
        pts = rng.uniform(-1, 1, (N, 3))
        axis = rng.integers(0, 3, N)
        pts[np.arange(N), axis] = np.sign(pts[np.arange(N), axis])
        pts += rng.normal(0, 0.005, pts.shape)
    else:   # a lattice: many neighbors at exactly equal distances
        g = np.arange(8, dtype=np.float32) * 0.25
        pts = np.stack(np.meshgrid(g, g, g[:4], indexing="ij"), -1).reshape(-1, 3)
    valid = rng.random(N) > 0.1
    return pts.astype(np.float32), valid


KINDS = ["plane", "box", "lattice"]


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kind", KINDS)
def test_knn_matches_jax(kind):
    pts, valid = cloud(kind)
    idx, dist = pc.knn(t(pts), t(valid), K)
    ridx, rdist = jc.knn(jnp.asarray(pts), jnp.asarray(valid), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(rdist), rtol=1e-6, atol=1e-6)
    if kind == "lattice":
        # ties: equal distances inside a row, taken in index order
        d = dist.numpy()[valid]
        assert (np.diff(d, axis=1) == 0).any()


@pytest.mark.parametrize("kind", KINDS)
def test_normals_match_jax(kind):
    pts, valid = cloud(kind)
    nbr = np.asarray(jc.knn(jnp.asarray(pts), jnp.asarray(valid), K)[0])
    n = pc.compute_normals(t(pts), t(valid), t(nbr).long()).numpy()
    ref = np.asarray(jc.compute_normals(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(nbr)))
    if kind == "lattice":
        # a planar lattice neighborhood's smallest axis is well defined;
        # rows with a repeated smallest eigenvalue have no unique normal
        cov_eigs = np.linalg.eigvalsh(np.einsum(
            "nki,nkj->nij", pts[nbr] - pts[nbr].mean(1, keepdims=True),
            pts[nbr] - pts[nbr].mean(1, keepdims=True)).astype(np.float64))
        unique = cov_eigs[:, 1] - cov_eigs[:, 0] > 1e-3
    else:
        unique = np.ones(N, bool)
    np.testing.assert_allclose(np.abs(np.sum(n * ref, -1))[unique], 1.0, atol=ATOL)
    # aligned to a previous normal, the sign is the reference's
    prev = ref + np.float32(0.01)
    n_al = pc.compute_normals(t(pts), t(valid), t(nbr).long(), t(prev)).numpy()
    ref_al = np.asarray(jc.compute_normals(jnp.asarray(pts), jnp.asarray(valid),
                                           jnp.asarray(nbr), jnp.asarray(prev)))
    np.testing.assert_allclose(n_al[unique], ref_al[unique], atol=ATOL)


@pytest.mark.parametrize("kind", ["plane", "box"])
def test_mollify_and_characteristics_match_jax(kind):
    pts, valid = cloud(kind)
    nbr, dist = jc.knn(jnp.asarray(pts), jnp.asarray(valid), K)
    normals = np.asarray(jc.compute_normals(jnp.asarray(pts), jnp.asarray(valid), nbr))
    got = pc.mollify_normals(t(pts), t(normals), t(valid), 0.5, 0.2, iterations=2).numpy()
    want = np.asarray(jc.mollify_normals(jnp.asarray(pts), jnp.asarray(normals),
                                         jnp.asarray(valid), 0.5, 0.2, iterations=2))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    port = pc.compute_characteristics(t(pts), t(normals), t(valid), t(np.asarray(nbr)).long(),
                                      t(np.asarray(dist)))
    ref = jc.compute_characteristics(jnp.asarray(pts), jnp.asarray(normals),
                                     jnp.asarray(valid), nbr, dist)
    for name, a, b in zip(("dissimilarity", "distance score", "homogeneity"), port, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL * max(1.0, np.abs(b).max()),
                                   err_msg=name)


def lapack_eigh(a: torch.Tensor):
    """numpy's symmetric eigensolver (LAPACK, as the JAX package's on the
    CPU): its eigenvector signs are JAX's on these clouds."""
    w, V = np.linalg.eigh(a.numpy())
    return torch.from_numpy(w), torch.from_numpy(V)


@pytest.mark.parametrize("solver", ["lapack", "own"])
@pytest.mark.parametrize("kind", ["plane"])
def test_reposition_points_matches_jax(kind, solver, monkeypatch):
    """Mollification weighs neighbors by ‖ni − nj‖², so the denoised cloud
    moves with the signs the eigensolver gives the normals (ROADMAP queue
    3): with JAX's signs (numpy's LAPACK) it is JAX's cloud within 2e-5 of
    the cloud's extent; with torch's own solver within REPOSITION_SIGN_ATOL.
    (Curved and cornered clouds spread further, as queue 3 records: after a
    step, near-tied neighbors change places.)"""
    pts, valid = cloud(kind)
    if solver == "lapack":
        monkeypatch.setattr(torch.linalg, "eigh", lapack_eigh)
    got = pc.reposition_points(t(pts), t(valid)).numpy()
    want = np.asarray(jc.reposition_points(jnp.asarray(pts), jnp.asarray(valid)))
    extent = float(np.ptp(pts[valid], axis=0).max())
    atol = SAME_SIGN_ATOL if solver == "lapack" else REPOSITION_SIGN_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * extent)
    np.testing.assert_array_equal(got[~valid], pts[~valid])
    if kind == "plane":
        # the denoising pulls the noisy plane flatter
        assert np.std(got[valid, 2]) < np.std(pts[valid, 2])


def voi_scene(kind: str):
    """(R (K, 3, 3), t (K, 3), near (K,), far (K,), valid (K,))."""
    if kind == "ring":
        # tests/test_analysis_fuser.py's 4 cameras on a ring looking inward
        Rs, ts = [], []
        for a in np.linspace(0, 2 * np.pi, 4, endpoint=False):
            c = np.array([3 * np.cos(a), 0.0, 3 * np.sin(a)])
            fwd = -c / np.linalg.norm(c)
            x = np.cross([0.0, 1.0, 0.0], fwd)
            x /= np.linalg.norm(x)
            R = np.stack([x, np.cross(fwd, x), fwd])
            Rs.append(R)
            ts.append(-R @ c)
        n = 4
        R, tt = np.asarray(Rs, np.float32), np.asarray(ts, np.float32)
        return R, tt, np.full(n, 2.0, np.float32), np.full(n, 4.0, np.float32), np.ones(n, bool)
    rng = np.random.default_rng(5)
    n = 12
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = quat_to_rot(t(q.astype(np.float32))).numpy()
    near = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return (R, rng.normal(size=(n, 3)).astype(np.float32), near,
            (near + rng.uniform(0.5, 3.0, n)).astype(np.float32), rng.random(n) > 0.2)


@pytest.mark.parametrize("kind", ["ring", "random"])
def test_volume_of_interest_matches_jax(kind):
    R, tt, near, far, valid = voi_scene(kind)
    s, js = pv.VoiSettings(), jv.VoiSettings()
    kf = pv.make_voi_keyframes(Pose(t(R), t(tt)), t(near), t(far), t(valid), s)
    jkf = jv.make_voi_keyframes(JPose(jnp.asarray(R), jnp.asarray(tt)), jnp.asarray(near),
                                jnp.asarray(far), jnp.asarray(valid), js)
    for name, a, b in zip(kf._fields, kf, jkf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6, err_msg=name)
    probe = np.random.default_rng(7).uniform(-4, 4, (500, 3)).astype(np.float32)
    sc = pv.teardrop_scores(kf, t(probe), s).numpy()
    ref_sc = np.asarray(jv.teardrop_scores(jkf, jnp.asarray(probe), js))
    np.testing.assert_allclose(sc, ref_sc, rtol=0, atol=ATOL * max(1.0, ref_sc.max()))
    lo, hi, ok = pv.calculate_volume_of_interest(kf, s)
    rlo, rhi, rok = jv.calculate_volume_of_interest(jkf, js)
    assert bool(ok) == bool(rok)
    np.testing.assert_allclose(lo.numpy(), np.asarray(rlo), atol=ATOL)
    np.testing.assert_allclose(hi.numpy(), np.asarray(rhi), atol=ATOL)
    if kind == "ring":
        assert bool(ok) and (lo.numpy() < 0).all() and (hi.numpy() > 0).all()


# --------------------------------------------------------------------------- #
# the photoreal session's end state

@pytest.fixture(scope="module")
def end_state():
    with np.load(PHOTOREAL) as z:
        photo = {k: z[k] for k in z.files if k.startswith("final_map")}
    with np.load(VI_FIXTURE) as z:
        ref = {k: z[k] for k in z.files if k.startswith("pr_")}
    m = interop.unflatten(MapState, "final_map", photo, "cpu")
    ph = interop.unflatten(PoseHistory, "pr_ph", ref, "cpu")
    return m, ph, ref


def test_fossilized_map_matches_jax(end_state):
    m, ph, ref = end_state
    fm = FossilizedMap(m, ph, golden_path_settings().MonoSettings.MonoCamera
                       .FeatureExtractorSettings)
    ids, mats = fm.trajectory()
    want = ref["pr_live_mats"][ref["pr_live_has"]]
    np.testing.assert_array_equal(ids, np.flatnonzero(ref["pr_live_has"]))
    np.testing.assert_allclose(mats, want, atol=1e-5)
    got = fm.get_tracking_results(range(-1, 81))
    assert got[0] is None and got[-1] is None
    assert [g is not None for g in got[1:81]] == ref["pr_live_has"].tolist()
    raw = fm.map_points()
    np.testing.assert_array_equal(raw, ref["pr_fm_points_raw"])
    extent = float(np.ptp(raw, axis=0).max())
    dn = fm.map_points(denoised=True)
    assert dn.shape == ref["pr_fm_points"].shape
    np.testing.assert_allclose(dn, ref["pr_fm_points"], rtol=0, atol=REPOSITION_SIGN_ATOL * extent)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.linalg, "eigh", lapack_eigh)
        dn = fm.map_points(denoised=True)
    np.testing.assert_allclose(dn, ref["pr_fm_points"], rtol=0, atol=SAME_SIGN_ATOL * extent)
    voi = fm.try_get_volume_of_interest()
    assert (voi is not None) == bool(ref["pr_fm_voi_ok"])
    np.testing.assert_allclose(np.stack(voi), ref["pr_fm_voi"], atol=ATOL)


@pytest.mark.parametrize("solver", ["lapack", "own"])
def test_fossilized_map_matches_live_jax_at_256_points(end_state, solver, monkeypatch):
    """Both FossilizedMaps live on the same state: the end state's keyframes
    and pose history with its first N = 256 point slots (190 valid).
    Trajectory, tracking results, raw cloud and volume of interest as JAX's;
    the denoised cloud within 2e-5 of its extent with JAX's normal signs,
    2e-3 with torch's own solver."""
    from types import SimpleNamespace

    from mageslam_tpu.runtime.fossilized import FossilizedMap as JaxFossilizedMap
    from mageslam_tpu.runtime.pose_history import PoseHistory as JaxPoseHistory

    m, ph, _ = end_state
    pos, valid = m.mp_pos[:N], m.mp_valid[:N]
    port = FossilizedMap(SimpleNamespace(kf_pose=m.kf_pose, mp_pos=pos, mp_valid=valid), ph,
                         None)
    ref = JaxFossilizedMap(
        SimpleNamespace(kf_pose=JPose(jnp.asarray(m.kf_pose.R.numpy()),
                                      jnp.asarray(m.kf_pose.t.numpy())),
                        mp_pos=jnp.asarray(pos.numpy()), mp_valid=jnp.asarray(valid.numpy())),
        JaxPoseHistory(*[jnp.asarray(x.numpy()) for x in ph]), None)
    ids, mats = port.trajectory()
    rids, rmats = ref.trajectory()
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_allclose(mats, rmats, atol=1e-5)
    for got, want in zip(port.get_tracking_results([0, 5, 40, 79, 200]),
                         ref.get_tracking_results([0, 5, 40, 79, 200])):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_allclose(got, want, atol=1e-5)
    raw = port.map_points()
    np.testing.assert_array_equal(raw, ref.map_points())
    assert len(raw) == int(valid.sum()) == 190
    if solver == "lapack":
        monkeypatch.setattr(torch.linalg, "eigh", lapack_eigh)
    extent = float(np.ptp(raw, axis=0).max())
    atol = SAME_SIGN_ATOL if solver == "lapack" else REPOSITION_SIGN_ATOL
    np.testing.assert_allclose(port.map_points(denoised=True), ref.map_points(denoised=True),
                               rtol=0, atol=atol * extent)
    np.testing.assert_allclose(np.stack(port.try_get_volume_of_interest()),
                               np.stack(ref.try_get_volume_of_interest()), atol=ATOL)


def test_live_queries_match_jax(end_state):
    m, ph, ref = end_state
    s = SlamSession(golden_path_settings(), (216.6, 216.6, 160.0, 90.0), 320, 180,
                    device="cpu")
    assert s.try_get_volume_of_interest() is None            # before the map exists
    s.map, s.pose_history, s.initialized = m, ph, True
    got = s.get_tracking_results_for_frames(range(80))
    assert [g is not None for g in got] == ref["pr_live_has"].tolist()
    np.testing.assert_allclose(np.stack([g for g in got if g is not None]),
                               ref["pr_live_mats"][ref["pr_live_has"]], atol=1e-5)
    voi = s.try_get_volume_of_interest()
    assert (voi is not None) == bool(ref["pr_live_voi_ok"])
    np.testing.assert_allclose(np.stack(voi), ref["pr_live_voi"], atol=ATOL)
    # with fewer than two poses the live query declines
    s.pose_history = PoseHistory.empty(ph.frame_id.shape[0], ph.connections, device="cpu")
    assert s.try_get_volume_of_interest() is None
