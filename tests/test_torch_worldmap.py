"""The port's map functions (map_state, member_index, covisibility,
operations, new_points, triangulation, epipolar) against the JAX package on
a JAX-built map at small capacity (K = 8 keyframes, P = 256 points, N = 64
feature slots). The scene comes from a numpy seed; each function runs in
both packages on the same state. Integer and mask outputs must be equal;
floats agree to atol 1e-5 (float32 sums in another order), a few named
cases to a looser stated bound."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mageslam_tpu.geometry import epipolar as jepi
from mageslam_tpu.geometry import triangulation as jtri
from mageslam_tpu.geometry.se3 import Pose as JPose
from mageslam_tpu.geometry.se3 import exp_so3 as jexp_so3
from mageslam_tpu.worldmap import covisibility as jcov
from mageslam_tpu.worldmap import map_state as jms
from mageslam_tpu.worldmap import member_index as jmi
from mageslam_tpu.worldmap import new_points as jnp_mod
from mageslam_tpu.worldmap import operations as jops
from mageslam_tpu_torch import interop
from mageslam_tpu_torch.geometry import epipolar, triangulation
from mageslam_tpu_torch.geometry.se3 import Pose
from mageslam_tpu_torch.worldmap import covisibility, map_state, member_index
from mageslam_tpu_torch.worldmap import new_points, operations

# the suite runs several worker processes on few cores: a small thread pool
# each costs less than the default of one thread a core
torch.set_num_threads(2)

K, P, N = 8, 256, 64
LEVELS, SCALE = 3, 1.2
CAM = np.array([300.0, 300.0, 160.0, 120.0], np.float32)
W, H = 320, 240
N_SHARED = 40        # associated features a keyframe
N_FRESH = 20         # unassociated features that see common, unmapped points


def to_torch(state, cls=map_state.MapState):
    """A JAX state NamedTuple as the port's, through the snapshot leaf order."""
    leaves = {f"s{i}": np.asarray(x) for i, x in enumerate(jax.tree.flatten(state)[0])}
    return interop.unflatten(cls, "s", leaves, "cpu")


def T(a):
    return torch.from_numpy(np.asarray(a).copy())


def assert_same(got, want, atol=1e-5, names=None):
    """Every leaf of the port's state `got` against the JAX state `want`."""
    g, w = interop.to_numpy(got), jax.tree.flatten(want)[0]
    assert len(g) == len(w)
    for (name, a), b in zip(g.items(), w):
        if names is not None and name.split(".")[0] not in names:
            continue
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def flip_bits(rng, desc, n_bits):
    out = desc.copy()
    for _ in range(n_bits):
        w = rng.randint(0, 8, desc.shape[0])
        out[np.arange(desc.shape[0]), w] ^= (1 << rng.randint(0, 32, desc.shape[0])).astype(np.uint32)
    return out


def build_scene(seed=0, n_kf=5, n_pts=100):
    """A JAX-built map: n_kf keyframes on a baseline looking at n_pts mapped
    points and N_FRESH unmapped ones, exact projections, descriptors a few
    bits off their point's. Keyframe i observes N_SHARED of the mapped
    points (a different subset each) and all the unmapped ones."""
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-1.5, 1.5, n_pts + N_FRESH), rng.uniform(-1, 1, n_pts + N_FRESH),
                    rng.uniform(4, 7, n_pts + N_FRESH)], 1).astype(np.float32)
    pt_desc = rng.randint(0, 2**32, (n_pts + N_FRESH, 8), dtype=np.uint64).astype(np.uint32)
    m = jms.empty_map(K, P, N)
    m = m._replace(
        mp_valid=m.mp_valid.at[:n_pts].set(True),
        mp_pos=m.mp_pos.at[:n_pts].set(jnp.asarray(pts[:n_pts])),
        mp_desc=m.mp_desc.at[:n_pts].set(jnp.asarray(pt_desc[:n_pts])),
        mp_found=m.mp_found.at[:n_pts].set(jnp.asarray(rng.randint(1, 9, n_pts), jnp.int32)),
        mp_predicted=m.mp_predicted.at[:n_pts].set(
            jnp.asarray(rng.randint(4, 12, n_pts), jnp.int32)),
        mp_refine_count=m.mp_refine_count.at[:n_pts].set(
            jnp.asarray(rng.randint(0, 4, n_pts), jnp.int32)),
    )
    frames = []
    for i in range(n_kf):
        R = np.asarray(jexp_so3(jnp.asarray(rng.randn(3).astype(np.float32) * 0.03)))
        center = np.array([0.35 * i, 0.05 * rng.randn(), 0.0], np.float32)
        pose = JPose(jnp.asarray(R), jnp.asarray(-R @ center))
        seen = np.sort(rng.choice(n_pts, N_SHARED, replace=False))
        ids = np.concatenate([seen, n_pts + rng.permutation(N_FRESH)])
        Xc = pts[ids] @ R.T + np.asarray(pose.t)
        uv = (CAM[:2] * Xc[:, :2] / Xc[:, 2:3] + CAM[2:]).astype(np.float32)
        n = len(ids)
        xy = np.zeros((N, 2), np.float32)
        xy[:n] = uv
        desc = np.zeros((N, 8), np.uint32)
        desc[:n] = flip_bits(rng, pt_desc[ids], 3)
        octave = np.zeros((N,), np.int32)
        octave[:n] = rng.randint(0, 2, n)
        assoc = np.full((N,), -1, np.int32)
        assoc[:N_SHARED] = seen
        valid = np.arange(N) < n
        frames.append((pose, xy, octave, desc, valid, assoc))
        m, _ = jops.insert_keyframe(m, pose, jnp.asarray(CAM), jnp.int32(10 * i),
                                    jnp.asarray(xy), jnp.asarray(octave), jnp.asarray(desc),
                                    jnp.asarray(valid), jnp.asarray(assoc),
                                    fixed=(i == 0), immortal=(i < 2))
    m = m._replace(mp_created_order=m.mp_created_order.at[:n_pts].set(
        jnp.asarray(rng.randint(0, n_kf, n_pts), jnp.int32)))
    m = jms.refresh_membership(m)
    m = jms.refresh_point_stats(m, m.mp_valid, LEVELS, SCALE)
    return m, frames, pts


@pytest.fixture(scope="module")
def scene():
    m, frames, pts = build_scene()
    return {"jax": m, "torch": to_torch(m), "frames": frames, "pts": pts}


def test_scene_crosses_unchanged(scene):
    assert_same(scene["torch"], scene["jax"], atol=0)
    assert int(scene["torch"].kf_valid.sum()) == 5 and scene["torch"].capacity == (K, P, N)


# ---- map_state ----------------------------------------------------------- #
def test_compute_dmin_dmax(rng):
    d = rng.uniform(0.5, 9, 50).astype(np.float32)
    o = rng.randint(0, LEVELS, 50).astype(np.int32)
    got = map_state.compute_dmin_dmax(T(d), T(o), LEVELS, SCALE)
    want = jms.compute_dmin_dmax(jnp.asarray(d), jnp.asarray(o), LEVELS, SCALE)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6)
    np.testing.assert_allclose(
        map_state.refinement_confidence(T(o)).numpy(),
        np.asarray(jms.refinement_confidence(jnp.asarray(o))), atol=1e-6)


@pytest.mark.parametrize("fn", ["point_keyframe_matrix", "observation_counts"])
def test_membership_views(scene, fn):
    np.testing.assert_array_equal(getattr(map_state, fn)(scene["torch"]).numpy(),
                                  np.asarray(getattr(jms, fn)(scene["jax"])))


def test_refresh_membership_and_octave_histogram(scene):
    stale = scene["jax"]._replace(kf_member=jnp.zeros((K, P), bool))
    assert_same(map_state.refresh_membership(to_torch(stale)), jms.refresh_membership(stale))
    got = map_state.point_octave_histogram(scene["torch"], LEVELS)
    want = jms.point_octave_histogram(scene["jax"], LEVELS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() == 5 * N_SHARED


def _moved(scene):
    """The scene with every point nudged, so a refresh has work to do."""
    rng = np.random.RandomState(5)
    return scene["jax"]._replace(mp_pos=scene["jax"].mp_pos + jnp.asarray(
        rng.randn(P, 3).astype(np.float32) * 0.05))


@pytest.mark.parametrize("max_obs_kf", [16, 2])
def test_refresh_point_stats(scene, max_obs_kf):
    m = _moved(scene)
    touched = np.random.RandomState(1).rand(P) < 0.6
    got = map_state.refresh_point_stats(to_torch(m), T(touched), LEVELS, SCALE, max_obs_kf)
    want = jms.refresh_point_stats(m, jnp.asarray(touched), LEVELS, SCALE, max_obs_kf)
    assert_same(got, want)
    assert not np.allclose(np.asarray(want.mp_dmin), np.asarray(m.mp_dmin))


@pytest.mark.parametrize("with_fidx", [False, True])
def test_refresh_point_stats_slots(scene, with_fidx):
    m = _moved(scene)
    rng = np.random.RandomState(2)
    slots = np.full((48,), -1, np.int32)
    slots[:30] = rng.choice(100, 30, replace=False)
    slots = rng.permutation(slots)
    jf = jmi.build_fidx(m) if with_fidx else None
    tf = T(jf) if with_fidx else None
    got = map_state.refresh_point_stats_slots(to_torch(m), T(slots), LEVELS, SCALE,
                                              max_obs_kf=4, fidx=tf)
    want = jms.refresh_point_stats_slots(m, jnp.asarray(slots), LEVELS, SCALE,
                                         max_obs_kf=4, fidx=jf)
    assert_same(got, want)


def test_grow_map(scene):
    got = map_state.grow_map(scene["torch"], 16, 512)
    assert_same(got, jms.grow_map(scene["jax"], 16, 512), atol=0)
    assert got.capacity == (16, 512, N)
    with pytest.raises(ValueError):
        map_state.grow_map(scene["torch"], 4, 512)


# ---- member_index -------------------------------------------------------- #
def test_build_fidx_and_views(scene):
    jf = jmi.build_fidx(scene["jax"])
    tf = member_index.build_fidx(scene["torch"])
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(member_index.member_of(tf).numpy(),
                                  np.asarray(scene["jax"].kf_member))
    np.testing.assert_array_equal(
        member_index.octave_histogram_of(tf, scene["torch"].kf_kp_octave, LEVELS).numpy(),
        np.asarray(jmi.octave_histogram_of(jf, scene["jax"].kf_kp_octave, LEVELS)))


def test_fidx_row_updates(scene):
    jf = jmi.build_fidx(scene["jax"])
    rng = np.random.RandomState(3)
    row = np.where(rng.rand(N) < 0.5, rng.randint(0, 100, N), -1).astype(np.int32)
    row[5] = row[3] = 17                     # two features on one point: lowest wins
    kpv = rng.rand(N) < 0.9
    got = member_index.fidx_set_row(T(jf), torch.tensor(2), T(row), T(kpv))
    want = jmi.fidx_set_row(jf, jnp.int32(2), jnp.asarray(row), jnp.asarray(kpv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[2, 17] == 3

    ks = np.array([4, 1, 3], np.int32)
    rows = np.where(rng.rand(3, N) < 0.5, rng.randint(0, 100, (3, N)), -1).astype(np.int32)
    kpvs = rng.rand(3, N) < 0.9
    ok = np.array([True, False, True])
    for kfv in (None, np.asarray(scene["jax"].kf_valid) & (np.arange(K) != 4)):
        got = member_index.fidx_set_rows(T(jf), T(ks), T(rows), T(kpvs), T(ok),
                                         kf_valid=None if kfv is None else T(kfv))
        want = jmi.fidx_set_rows(jf, jnp.asarray(ks), jnp.asarray(rows), jnp.asarray(kpvs),
                                 jnp.asarray(ok),
                                 kf_valid=None if kfv is None else jnp.asarray(kfv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fidx_point_updates(scene):
    jf = jmi.build_fidx(scene["jax"])
    rng = np.random.RandomState(4)
    ks = rng.randint(0, 5, 30).astype(np.int32)
    pts = (100 + np.arange(30)).astype(np.int32)          # distinct (k, point) pairs
    feats = rng.randint(0, N, 30).astype(np.int32)
    want_mask = rng.rand(30) < 0.7
    got = member_index.fidx_add(T(jf), T(ks), T(feats), T(pts), T(want_mask))
    want = jmi.fidx_add(jf, jnp.asarray(ks), jnp.asarray(feats), jnp.asarray(pts),
                        jnp.asarray(want_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got2 = member_index.fidx_remove_obs(got, T(ks), T(pts), T(~want_mask | (ks == 1)))
    want2 = jmi.fidx_remove_obs(want, jnp.asarray(ks), jnp.asarray(pts),
                                jnp.asarray(~want_mask | (ks == 1)))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
    gone_p, gone_k = rng.rand(P) < 0.3, np.arange(K) == 2
    np.testing.assert_array_equal(
        member_index.fidx_remove_points(T(jf), T(gone_p)).numpy(),
        np.asarray(jmi.fidx_remove_points(jf, jnp.asarray(gone_p))))
    np.testing.assert_array_equal(
        member_index.fidx_remove_keyframes(T(jf), T(gone_k)).numpy(),
        np.asarray(jmi.fidx_remove_keyframes(jf, jnp.asarray(gone_k))))


# ---- covisibility -------------------------------------------------------- #
def test_covisibility(scene):
    got = covisibility.covisibility_matrix(scene["torch"])
    want = jcov.covisibility_matrix(scene["jax"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.max() > 5 and (got.diagonal() == 0).all()
    member = member_index.build_fidx(scene["torch"]) >= 0
    np.testing.assert_array_equal(
        covisibility.covisibility_matrix(scene["torch"], member).numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        covisibility.connected_keyframes(got, 1, 10).numpy(),
        np.asarray(jcov.connected_keyframes(want, 1, 10)))


# ---- operations ---------------------------------------------------------- #
def _insert_both(scene, i, tstate, jstate):
    pose, xy, octave, desc, valid, assoc = scene["frames"][i]
    assoc = assoc.copy()
    assoc[2] = 200                                     # an invalid point: cleaned
    j, js = jops.insert_keyframe(jstate, pose, jnp.asarray(CAM), jnp.int32(99),
                                 jnp.asarray(xy), jnp.asarray(octave), jnp.asarray(desc),
                                 jnp.asarray(valid), jnp.asarray(assoc))
    t, ts = operations.insert_keyframe(
        tstate, Pose(T(pose.R), T(pose.t)), T(CAM), torch.tensor(99, dtype=torch.int32),
        T(xy), T(octave), T(desc.view(np.int32)), T(valid), T(assoc))
    return t, ts, j, js


def test_insert_keyframe_until_the_bank_is_full(scene):
    t, j = scene["torch"], scene["jax"]
    for want_slot in (5, 6, 7, -1):
        t, ts, j, js = _insert_both(scene, 1, t, j)
        assert int(ts) == int(js) == want_slot
        assert_same(t, j, atol=0)


def test_create_map_points(scene, rng):
    j0, t0 = scene["jax"], scene["torch"]
    M = 40
    pos = rng.randn(M, 3).astype(np.float32)
    desc = rng.randint(0, 2**32, (M, 8), dtype=np.uint64).astype(np.uint32)
    kf_a, kf_b = np.full((M,), 4, np.int32), rng.randint(0, 4, M).astype(np.int32)
    feat_a = (N_SHARED + np.arange(M) % (N - N_SHARED)).astype(np.int32)
    feat_b = (N_SHARED + (np.arange(M) * 7) % (N - N_SHARED)).astype(np.int32)
    want_mask = rng.rand(M) < 0.5
    want_mask[N - N_SHARED:] = False                  # distinct (keyframe, feature) pairs
    for fill in (False, True):                        # with room, then nearly full
        j, t = j0, t0
        if fill:
            j = j._replace(mp_valid=j.mp_valid.at[:P - 4].set(True))
            t = t._replace(mp_valid=T(np.asarray(j.mp_valid)))
        got, got_slots = operations.create_map_points(
            t, T(pos), T(desc.view(np.int32)), T(kf_a), T(feat_a), T(kf_b), T(feat_b),
            T(want_mask))
        want, want_slots = jops.create_map_points(
            j, jnp.asarray(pos), jnp.asarray(desc), jnp.asarray(kf_a), jnp.asarray(feat_a),
            jnp.asarray(kf_b), jnp.asarray(feat_b), jnp.asarray(want_mask))
        np.testing.assert_array_equal(got_slots.numpy(), np.asarray(want_slots))
        assert_same(got, want, atol=0)
        assert int((got_slots >= 0).sum()) == (4 if fill else int(want_mask.sum()))


def test_remove_map_points_and_keyframes(scene, rng):
    gone = rng.rand(P) < 0.3
    assert_same(operations.remove_map_points(scene["torch"], T(gone)),
                jops.remove_map_points(scene["jax"], jnp.asarray(gone)), atol=0)
    for ks in ([3], [1, 2, 3]):                       # the second orphans points
        rm = np.isin(np.arange(K), ks)
        assert_same(operations.remove_keyframes(scene["torch"], T(rm)),
                    jops.remove_keyframes(scene["jax"], jnp.asarray(rm)), atol=0)
        jf = jmi.build_fidx(scene["jax"])
        got, got_f = operations.remove_keyframes(scene["torch"], T(rm), fidx=T(jf))
        want, want_f = jops.remove_keyframes(scene["jax"], jnp.asarray(rm), fidx=jf)
        assert_same(got, want, atol=0)
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    assert int(got.mp_valid.sum()) < int(scene["torch"].mp_valid.sum())


@pytest.mark.parametrize("with_fidx", [False, True])
def test_cull_recent_map_points(scene, with_fidx, rng):
    failed = rng.rand(P) < 0.2
    jf = jmi.build_fidx(scene["jax"]) if with_fidx else None
    got = operations.cull_recent_map_points(
        scene["torch"], torch.tensor(4), T(failed), 3, fidx=T(jf) if with_fidx else None)
    want = jops.cull_recent_map_points(scene["jax"], jnp.int32(4), jnp.asarray(failed), 3,
                                       fidx=jf)
    if with_fidx:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        got, want = got[0], want[0]
    assert_same(got, want, atol=0)
    culled = int(scene["torch"].mp_valid.sum()) - int(got.mp_valid.sum())
    assert 0 < culled < 100


@pytest.mark.parametrize("with_fidx", [False, True])
def test_cull_local_keyframes(with_fidx):
    # every keyframe sees the same points at octave 0: keyframes 2-4 are
    # redundant, and each cull lowers the others' redundancy
    m, _, _ = build_scene(seed=3, n_kf=6, n_pts=N_SHARED)
    m = m._replace(kf_kp_octave=jnp.zeros_like(m.kf_kp_octave))
    t = to_torch(m)
    covis = jcov.covisibility_matrix(m)
    jf = jmi.build_fidx(m) if with_fidx else None
    got = operations.cull_local_keyframes(t, torch.tensor(5), T(covis), LEVELS, 15, 0.9, 3,
                                          fidx=T(jf) if with_fidx else None)
    want = jops.cull_local_keyframes(m, jnp.int32(5), covis, LEVELS, 15, 0.9, 3, fidx=jf)
    assert_same(got[0], want[0], atol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if with_fidx:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 1 <= int(got[1].sum()) <= 3 and not got[1][:2].any()


# ---- new points ---------------------------------------------------------- #
@pytest.mark.parametrize("max_grid_count,max_new_points", [(6, 256), (40, 7)])
def test_create_new_map_points(scene, max_grid_count, max_new_points):
    jf = jmi.build_fidx(scene["jax"])
    covis = jcov.covisibility_matrix(scene["jax"])
    kw = dict(num_levels=LEVELS, pyramid_scale=SCALE, image_width=W, image_height=H,
              covis_theta=5, max_frames=3, max_hamming=45, min_hamming_diff=8,
              min_distance_ratio=2.0, max_grid_count=max_grid_count,
              max_new_points=max_new_points)
    want = jnp_mod.create_new_map_points(scene["jax"], jnp.int32(4), covis,
                                         jnp.float32(1.0), fidx=jf, **kw)
    got = new_points.create_new_map_points(scene["torch"], torch.tensor(4), T(covis), 1.0,
                                           fidx=T(jf), **kw)
    assert int(got.created) == int(want.created) > 3
    np.testing.assert_array_equal(got.slots.numpy(), np.asarray(want.slots))
    np.testing.assert_array_equal(got.fidx.numpy(), np.asarray(want.fidx))
    assert_same(got.state, want.state, atol=2e-5)
    # the new points are re-associated into keyframes beyond the two that made them
    n_obs = (got.fidx[:, got.slots[got.slots >= 0].long()] >= 0).sum(0)
    assert int(n_obs.max()) >= 3
    if max_new_points == 7:
        assert int(got.created) == 7


# ---- geometry ------------------------------------------------------------ #
def _two_views(rng, n):
    R1 = np.asarray(jexp_so3(jnp.asarray(rng.randn(3).astype(np.float32) * 0.05)))
    R2 = np.asarray(jexp_so3(jnp.asarray(rng.randn(3).astype(np.float32) * 0.05)))
    t1, t2 = np.zeros(3, np.float32), np.array([-0.4, 0.02, 0.01], np.float32)
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(3, 6, n)],
                 1).astype(np.float32)
    px = []
    for R, t in ((R1, t1), (R2, t2)):
        Xc = X @ R.T + t
        px.append((CAM[:2] * Xc[:, :2] / Xc[:, 2:3] + CAM[2:]
                   + rng.randn(n, 2) * 0.3).astype(np.float32))
    return (R1, t1), (R2, t2), px, X


def test_triangulation(rng):
    (R1, t1), (R2, t2), (px1, px2), X = _two_views(rng, 50)
    jp1, jp2 = JPose(jnp.asarray(R1), jnp.asarray(t1)), JPose(jnp.asarray(R2), jnp.asarray(t2))
    p1, p2 = Pose(T(R1), T(t1)), Pose(T(R2), T(t2))
    jcam, tcam = jnp.asarray(CAM), T(CAM)
    for name in ("triangulate_midpoint", "triangulate_dlt"):
        got = getattr(triangulation, name)(tcam, p1, T(px1), tcam, p2, T(px2))
        want = getattr(jtri, name)(jcam, jp1, jnp.asarray(px1), jcam, jp2, jnp.asarray(px2))
        # depth is ill-conditioned at this baseline: 1e-3 of a 3-6 unit depth
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, err_msg=name)
        assert np.abs(got.numpy() - X).max() < 0.5
    o, d = triangulation.backproject_rays(tcam, p2, T(px2))
    jo, jd = jtri.backproject_rays(jcam, jp2, jnp.asarray(px2))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    err, z = triangulation.reprojection_error(tcam, p2, T(X), T(px2))
    jerr, jz = jtri.reprojection_error(jcam, jp2, jnp.asarray(X), jnp.asarray(px2))
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-6)


def test_epipolar(rng):
    (R1, t1), (R2, t2), (px1, px2), _ = _two_views(rng, 50)
    jp1, jp2 = JPose(jnp.asarray(R1), jnp.asarray(t1)), JPose(jnp.asarray(R2), jnp.asarray(t2))
    p1, p2 = Pose(T(R1), T(t1)), Pose(T(R2), T(t2))
    E = epipolar.essential_matrix(p1, p2)
    np.testing.assert_allclose(E.numpy(), np.asarray(jepi.essential_matrix(jp1, jp2)), atol=1e-6)
    F = epipolar.fundamental_matrix(p1, T(CAM), p2, T(CAM))
    jF = jepi.fundamental_matrix(jp1, jnp.asarray(CAM), jp2, jnp.asarray(CAM))
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), rtol=1e-5, atol=1e-7)
    d = epipolar.distance_from_epipolar_line(F, T(px1), T(px2))
    jd = jepi.distance_from_epipolar_line(jF, jnp.asarray(px1), jnp.asarray(px2))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=2e-3)   # pixels, ~1e-6 relative
    assert d.max() < 3.0
    s = epipolar.symmetric_transfer_error(F, T(px1), T(px2))
    js = jepi.symmetric_transfer_error(jF, jnp.asarray(px1), jnp.asarray(px2))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=5e-3)
