"""The plain reference against the program at small sizes on the CPU, and
the control (the reference in TF32 in the program's place) against the
limits: the program's outputs pass, the control's fail."""

import numpy as np
import pytest
import torch

from slambench import check, harness
from slambench.reference import frontend as ref_frontend
from slambench.reference import lm as ref_lm

torch.set_num_threads(2)
LIM = check.limits()


CFG = harness.config(harness.benchmark(), "mono320_golden")
CAM = tuple(CFG["camera"]["pinhole"])
FX, FY, CX, CY = CAM


def fes(levels):
    from mageslam_tpu_torch.config import golden_path_settings

    s = harness.override(golden_path_settings(), CFG["settings"])
    if levels != 1:         # the octave path, which no cell drives yet
        s = harness.override(s, {"MonoSettings": {"MonoCamera": {
            "FeatureExtractorSettings": {"NumLevels": levels}}}})
    return s.MonoSettings.MonoCamera.FeatureExtractorSettings


@pytest.mark.parametrize("levels", [1, 3])
def test_frontend_equals_the_program_on_a_seeded_frame(levels):
    from mageslam_tpu_torch.geometry.camera import make_pinhole
    from mageslam_tpu_torch.ops.frontend import detect_and_compute

    world = harness.generator("patch_world").World(2**31 + 11, harness.traffic("explore"), CFG)
    img = torch.from_numpy(world.frame(40))
    cam = CAM
    f = fes(levels)
    got = detect_and_compute(img.to(torch.float32), make_pinhole(*cam, world.width, world.height),
                             f, 512)
    items = [(0, got)]
    assert check.frontend_mismatch(items, img[None], f, cam, 512, control=False) == 0.0
    ctl = check.frontend_mismatch(items, img[None], f, cam, 512, control=True)
    assert ctl > LIM["frontend_mismatch"]
    ref = ref_frontend.detect(img, ref_frontend_fes(f), cam, 512)
    assert int(ref["valid"].sum()) > 200


def ref_frontend_fes(f):
    import dataclasses

    return dataclasses.asdict(f)


# the explore window's camera travels from x = 1.5 to x = 16: the problems
# sit at x = 10, where float32 and TF32 round the map's coordinates as there
X0 = 10.0


def pose_problem(seed, n=300):
    g = np.random.RandomState(seed)
    X = np.stack([g.uniform(-3, 3, n) + X0, g.uniform(-2, 2, n), g.uniform(3, 8, n)], 1)
    t_true = np.array([0.3 - X0, -0.1, 0.2])
    uv = np.stack([FX * (X[:, 0] + t_true[0]) / (X[:, 2] + t_true[2]) + CX,
                   FY * (X[:, 1] + t_true[1]) / (X[:, 2] + t_true[2]) + CY], 1)
    uv += g.normal(0, 0.5, uv.shape)
    uv[:10] += 15.0                                  # a few outliers under Huber
    info = (g.uniform(size=n) > 0.1).astype(np.float32)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return (torch.eye(3), f32(t_true + np.array([0.02, 0.01, -0.03])), f32(CAM),
            f32(X), f32(uv), f32(info))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_refinement_program_within_and_control_beyond_the_limit(seed):
    from mageslam_tpu_torch.ba.pose_only import optimize_pose
    from mageslam_tpu_torch.geometry.se3 import Pose

    R0, t0, cam, X, uv, info = pose_problem(seed)
    pose, _, _ = optimize_pose(Pose(R0, t0), cam, X, uv, info, huber_width=1.0, num_iters=10)
    item = {"R0": R0, "t0": t0, "cam": cam, "points": X, "uv": uv, "info": info, "huber": 1.0,
            "iters": 10, "R": pose.R, "t": pose.t}
    prog = check.pose_gap_px([item], control=False)
    ctl = check.pose_gap_px([item], control=True)
    assert prog <= LIM["pose_gap_px"] < ctl
    # the reference's own float64 refinement reaches the noise floor
    R, t = ref_lm.optimize_pose(R0, t0, cam, X, uv, info, 1.0, 10)
    assert float(torch.linalg.norm(t - torch.tensor([0.3 - X0, -0.1, 0.2],
                                                    dtype=torch.float64))) < 0.01


def ba_problem(seed, K=6, P=200):
    from mageslam_tpu_torch.ba.problem import empty_problem
    from mageslam_tpu_torch.geometry.se3 import Pose

    g = np.random.RandomState(seed)
    X = np.stack([g.uniform(-3, 3, P) + X0, g.uniform(-2, 2, P), g.uniform(4, 8, P)], 1)
    cams_t = np.stack([np.linspace(0, 1.0, K) + X0, 0.05 * np.sin(np.arange(K)), np.zeros(K)], 1)
    obs_c, obs_p, obs_uv = [], [], []
    for k in range(K):
        for p in range(P):
            if g.uniform() < 0.8:
                x = X[p] - cams_t[k]
                obs_c.append(k)
                obs_p.append(p)
                obs_uv.append([FX * x[0] / x[2] + CX, FY * x[1] / x[2] + CY])
    obs_uv = np.array(obs_uv) + g.normal(0, 0.4, (len(obs_uv), 2))
    O = len(obs_c)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    pr = empty_problem(K, P, O, n_tethers=0)
    t = -cams_t + g.normal(0, 0.01, cams_t.shape) * (np.arange(K) >= 2)[:, None]
    return pr._replace(
        poses=Pose(torch.eye(3).repeat(K, 1, 1), f32(t)),
        intrinsics=f32([CAM] * K),
        cam_fixed=torch.tensor([True, True] + [False] * (K - 2)),
        cam_valid=torch.ones(K, dtype=torch.bool),
        points=f32(X + g.normal(0, 0.02, X.shape)), pt_valid=torch.ones(P, dtype=torch.bool),
        obs_cam=torch.tensor(obs_c, dtype=torch.int32),
        obs_pt=torch.tensor(obs_p, dtype=torch.int32),
        obs_uv=f32(obs_uv), obs_info=torch.ones(O))


@pytest.mark.parametrize("seed", [0, 1])
def test_bundle_adjustment_program_within_and_control_beyond_the_limit(seed):
    from mageslam_tpu_torch.ba.problem import BAState
    from mageslam_tpu_torch.ba.step import step_bundle_adjust

    pr = ba_problem(seed)
    widths = [0.9 * 0.8 ** i for i in range(4)]
    st, _, _ = step_bundle_adjust(pr, BAState.from_problem(pr), widths, 9.0)
    item = {"problem": {"poses_R": pr.poses.R, "poses_t": pr.poses.t,
                        "intrinsics": pr.intrinsics, "cam_fixed": pr.cam_fixed,
                        "cam_valid": pr.cam_valid, "points": pr.points, "pt_valid": pr.pt_valid,
                        "obs_cam": pr.obs_cam, "obs_pt": pr.obs_pt, "obs_uv": pr.obs_uv,
                        "obs_info": pr.obs_info},
            "tether_weight": pr.tether_weight, "widths": widths, "max_error_sq": 9.0,
            "R": st.poses.R, "t": st.poses.t, "X": st.points}
    prog = check.ba_gap_px([item], control=False)
    ctl = check.ba_gap_px([item], control=True)
    assert prog <= LIM["ba_gap_px"] < ctl


def descriptors(g, n, pool):
    """(n, 8) int32 words drawn near the descriptors of `pool` (one for all
    the sides of a test), a bit or two flipped, so that distances tie
    often."""
    d = pool[g.randint(0, len(pool), n)].copy()
    for i in range(n):
        for _ in range(g.randint(0, 3)):
            w, b = g.randint(8), g.randint(32)
            d[i, w] ^= np.int64(1) << b
    return torch.tensor(((d + 2**31) % 2**32 - 2**31).astype(np.int32))


@pytest.mark.parametrize("seed, stages, group_rows", [(0, 3, None), (1, 1, None), (2, 1, 16),
                                                      (3, 2, 100)])
def test_radius_match_equals_the_program(seed, stages, group_rows):
    from mageslam_tpu_torch.ops.matching import radius_match_stages

    g = np.random.RandomState(seed)
    q, t = 160, 120
    pool = g.randint(-2**31, 2**31, (30, 8), dtype=np.int64)
    args = dict(
        query_desc=descriptors(g, q, pool),
        query_xy=torch.tensor(g.uniform(0, 40, (stages, q, 2)), dtype=torch.float32),
        query_octave=torch.tensor(g.randint(0, 2, q), dtype=torch.int32),
        query_valid=torch.tensor(g.uniform(size=q) > 0.1),
        target_desc=descriptors(g, t, pool),
        target_xy=torch.tensor(g.uniform(0, 40, (t, 2)), dtype=torch.float32),
        target_octave=torch.tensor(g.randint(0, 2, t), dtype=torch.int32),
        target_valid=torch.tensor(g.uniform(size=t) > 0.1),
        radius=torch.tensor(g.uniform(4, 20, (stages, q)), dtype=torch.float32),
        max_hamming=60, min_diff=2, octave_tol=int(seed % 2), group_rows=group_rows)
    got = radius_match_stages(**args)
    item = {"args": args, "out": got}
    value, counts = check.match_mismatch({"radius": [item]}, control=False)
    assert value == 0.0 and counts["radius"]["answers"] > 10
    # an answer altered where it is produced is caught
    idx = got[0].clone()
    k = int(torch.nonzero(idx[0] >= 0)[0])
    idx[0, k] = (idx[0, k] + 1) % t
    value, _ = check.match_mismatch({"radius": [{"args": args, "out": (idx, got[1])}]}, False)
    assert value > LIM["match_mismatch"]


@pytest.mark.parametrize("seed, shared", [(0, True), (1, False)])
def test_two_way_match_and_word_assignment_equal_the_program(seed, shared):
    from mageslam_tpu_torch.ops.bow_words import assign
    from mageslam_tpu_torch.ops.matching import match_two_way

    g = np.random.RandomState(seed)
    b, n, m = 3, 40, 50
    pool = g.randint(-2**31, 2**31, (30, 8), dtype=np.int64)
    desc_a = descriptors(g, n, pool) if shared else torch.stack([descriptors(g, n, pool)
                                                               for _ in range(b)])
    args = dict(desc_a=desc_a, valid_a=torch.tensor(g.uniform(size=(b, n)) > 0.1),
                desc_b=torch.stack([descriptors(g, m, pool) for _ in range(b)]),
                valid_b=torch.tensor(g.uniform(size=(b, m)) > 0.1), max_hamming=50, min_diff=1)
    words = dict(desc=descriptors(g, 70, pool), valid=torch.tensor(g.uniform(size=70) > 0.2),
                 anchors=descriptors(g, 12, pool))
    samples = {"two_way": [{"args": args, "out": match_two_way(**args)}],
               "bow": [{"args": words, "out": assign(**words)}]}
    value, counts = check.match_mismatch(samples, control=False)
    assert value == 0.0
    assert counts["two_way"]["answers"] > 5 and counts["bow"]["answers"] > 40
