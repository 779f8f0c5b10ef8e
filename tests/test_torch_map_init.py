"""The port's mono init (mageslam_tpu_torch/tracking/map_init.py) against
the JAX functions, with the JAX keys' Gumbel draws injected.

- `try_initialize_pair` at full width on the three attempts the JAX session
  made on the benchmark world (tests/data/torch_port_bench640_init.npz,
  written by `tools/export_jax_state.py init` and checked against a live JAX
  run in tests/test_torch_session.py), and against JAX's results on a
  synthetic two-view scene (N = 120, 64 hypotheses), a pure rotation and
  unrelated descriptors, both of which must fail (the draws of
  PRNGKey(0) and JAX's results in tests/data/torch_port_init_checks.npz,
  `tools/export_jax_state.py init_checks`).
- `validate_third_frame` live against JAX on the adoption's result and the
  middle frame the session checked it on.

Tolerances. Success, match count and the matched features exact. The
chosen RANSAC hypothesis may differ: the null-space basis of the 5-point
solver is not unique, so the candidates' float32 scores differ and another
sample of the same geometry can win. After the init BA, R agrees within
1e-3 (measured 1.8e-6 at full width). t is fixed only up to scale: frame 1
is the only fixed camera, so the BA's cost does not see the map's scale,
and where the LM leaves it depends on float noise in the start (JAX itself
moves it by 1.9 % between its jitted and eager runs of the same attempt:
tools/init_gauge.py). t is therefore compared as a direction, within 1e-3.
point_valid: exact at full width (measured 0 differing); on the synthetic
scene at most 3 of 120 differ.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mageslam_tpu.geometry.se3 import Pose as JPose
from mageslam_tpu.tracking import map_init as jm
from mageslam_tpu_torch import golden_path_settings
from mageslam_tpu_torch.geometry.se3 import Pose
from mageslam_tpu_torch.tracking import map_init as tm

torch.set_num_threads(2)

FIXTURE = "tests/data/torch_port_bench640_init.npz"
CHECKS = "tests/data/torch_port_init_checks.npz"
CAM = np.array([520.0, 520.0, 320.0, 240.0], np.float32)
R_ATOL = 1e-3
DIR_ATOL = 1e-3


def t_of(a: np.ndarray) -> torch.Tensor:
    """numpy → tensor, uint32 descriptor words as their int32 bit view."""
    return torch.from_numpy(np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32
                                                 else a))


def direction(t) -> np.ndarray:
    t = np.asarray(t, np.float64)
    return t / np.linalg.norm(t)


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("attempt", [0, 1, 2])
def test_attempts_at_full_width(fixture, attempt):
    p = f"init_att{attempt}_"
    res = tm.try_initialize_pair(*(t_of(fixture[p + k]) for k in
                                   ("xy1", "desc1", "valid1", "xy2", "desc2", "valid2")),
                                 torch.from_numpy(CAM), t_of(fixture[p + "draws"]),
                                 tm.init_settings(golden_path_settings()))
    assert bool(res.succeeded) == bool(fixture[p + "succeeded"])
    assert int(res.match_count) == int(fixture[p + "match_count"])
    np.testing.assert_array_equal(res.point_valid.numpy(), fixture[p + "point_valid"])
    matched = fixture[p + "feat2"] != 0
    np.testing.assert_array_equal(res.feat2.numpy()[matched], fixture[p + "feat2"][matched])
    if bool(fixture[p + "succeeded"]):
        np.testing.assert_allclose(res.pose2.R.numpy(), fixture[p + "pose2_R"], atol=R_ATOL)
        np.testing.assert_allclose(direction(res.pose2.t.numpy()),
                                   direction(fixture[p + "pose2_t"]), atol=DIR_ATOL)
        ok = res.point_valid.numpy()
        assert np.isfinite(res.points.numpy()[ok]).all()


def jax_result(fixture, attempt: int) -> jm.InitResult:
    p = f"init_att{attempt}_"
    n = fixture[p + "points"].shape[0]
    return jm.InitResult(
        succeeded=jnp.asarray(fixture[p + "succeeded"]),
        pose2=JPose(jnp.asarray(fixture[p + "pose2_R"]), jnp.asarray(fixture[p + "pose2_t"])),
        points=jnp.asarray(fixture[p + "points"]),
        point_valid=jnp.asarray(fixture[p + "point_valid"]),
        feat1=jnp.arange(n, dtype=jnp.int32), feat2=jnp.asarray(fixture[p + "feat2"]),
        match_count=jnp.asarray(fixture[p + "match_count"]))


def test_validate_third_frame_against_jax(fixture):
    attempt = int(fixture["init_n_attempt"]) - 1
    q = "init_third0_"
    jr = jax_result(fixture, attempt)
    ms = golden_path_settings().MonoSettings.MonoMapInitializationSettings
    kw = dict(min_pct=ms.MinThirdFrameMatchPercentage, max_err=ms.ExtraFrame_MaxOutlierError,
              ba_iters=ms.ExtraFrame_BundleAdjustmentSteps,
              max_hamming=ms.ExtraFrameMatchingSettings.MaxHammingDistance,
              min_diff=ms.ExtraFrameMatchingSettings.MinHammingDifference)
    anchor_desc = fixture[f"init_att{attempt}_desc1"]
    want = bool(jm.validate_third_frame(
        jr, jnp.asarray(anchor_desc), jnp.asarray(fixture[q + "anchor_valid"]),
        jnp.asarray(fixture[q + "xy"]), jnp.asarray(fixture[q + "desc"]),
        jnp.asarray(fixture[q + "valid"]), jnp.asarray(CAM), jnp.asarray(fixture[q + "key"]),
        **kw))
    assert want == bool(fixture[q + "ok"])
    tr = tm.InitResult(*(t_of(np.asarray(v)) if not isinstance(v, JPose)
                         else Pose(t_of(np.asarray(v.R)), t_of(np.asarray(v.t)))
                         for v in jr))
    got = tm.validate_third_frame(tr, t_of(anchor_desc), t_of(fixture[q + "anchor_valid"]),
                                  t_of(fixture[q + "xy"]), t_of(fixture[q + "desc"]),
                                  t_of(fixture[q + "valid"]), torch.from_numpy(CAM),
                                  t_of(fixture[q + "draws"]), **kw)
    assert bool(got) == want


def _features(rng, pts, R, t, K, noise=0.2):
    def project(Rm, tm_):
        Xc = pts @ Rm.T + tm_
        return np.stack([K[0] * Xc[:, 0] / Xc[:, 2] + K[2],
                         K[1] * Xc[:, 1] / Xc[:, 2] + K[3]], 1).astype(np.float32)

    uv1 = project(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    uv2 = project(R, t)
    uv1 += rng.normal(0, noise, uv1.shape).astype(np.float32)
    uv2 += rng.normal(0, noise, uv2.shape).astype(np.float32)
    return uv1, uv2


def _rotation(euler):
    a, b, c = euler
    Rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    Rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def synthetic_pair(case: str, n: int = 120):
    """(xy1, desc1, xy2, desc2, K) of the synthetic scene's cases (as
    tests/test_essential_init.py builds them)."""
    rng = np.random.RandomState(0)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 9, n)], 1).astype(np.float32)
    K = np.array([300.0, 300.0, 160.0, 120.0], np.float32)
    desc = np.random.RandomState(5).randint(0, 2**31, (n, 8)).astype(np.uint32)
    if case == "pure_rotation":
        R = _rotation((0.02, 0.04, -0.01))
        uv1, uv2 = _features(rng, pts, R, np.zeros(3, np.float32), K, noise=0.3)
        return uv1, desc, uv2, desc, K
    R = _rotation((0.03, -0.05, 0.01))
    t = (-R @ np.array([0.5, 0.05, 0.02], np.float32)).astype(np.float32)
    uv1, uv2 = _features(rng, pts, R, t, K)
    if case == "unrelated":
        other = rng.randint(0, 2**31, (n, 8)).astype(np.uint32)
        return uv1, desc, uv2, other, K
    perm = rng.permutation(n)                 # frame 2 in another order
    return uv1, desc, uv2[perm], desc[perm], K


@pytest.fixture(scope="module")
def checks():
    with np.load(CHECKS) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", ["two_view", "pure_rotation", "unrelated"])
def test_synthetic_pair_against_jax(checks, case):
    xy1, desc1, xy2, desc2, K = synthetic_pair(case)
    n = xy1.shape[0]
    valid = np.ones(n, bool)
    want = {k[len(case) + 4:]: v for k, v in checks.items() if k.startswith(f"sp_{case}_")}
    tr = tm.try_initialize_pair(t_of(xy1), t_of(desc1), t_of(valid), t_of(xy2), t_of(desc2),
                                t_of(valid), torch.from_numpy(K),
                                torch.from_numpy(checks["sp_draws"]), tm.InitSettings())
    assert bool(tr.succeeded) == bool(want["succeeded"]) == (case == "two_view")
    assert int(tr.match_count) == int(want["match_count"])
    if case != "two_view":
        assert not tr.point_valid.any()
        return
    matched = want["feat2"] != 0
    np.testing.assert_array_equal(tr.feat2.numpy()[matched], want["feat2"][matched])
    np.testing.assert_allclose(tr.pose2.R.numpy(), want["R"], atol=R_ATOL)
    np.testing.assert_allclose(direction(tr.pose2.t.numpy()), direction(want["t"]),
                               atol=DIR_ATOL)
    assert (tr.point_valid.numpy() != want["point_valid"]).sum() <= 3
