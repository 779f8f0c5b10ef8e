"""The port on an NVIDIA GPU: the CUDA kernels (standalone Hamming, fused
radius match, fused two-way match) against their plain versions, the
tracking slice and the first mapping event against the stored JAX outputs,
and local BA with live tethers against the same run on the CPU.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false. This file imports no JAX, so on a machine with a GPU and no JAX
it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch

from mageslam_tpu_torch import SlamSession, bench_world, golden_path_settings
from mageslam_tpu_torch.ops import hamming, matching

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_f30.npz")
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def words(rng, rows, device):
    w = rng.randint(0, 2**32, size=(rows, 8), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32).copy()).to(device)


# both sides of the tiles' edges: 16-row mma tiles, 64-row and 128-column
# blocks, 64-query blocks of the two-way scan
TILE_EDGES = (1, 15, 17, 63, 64, 65, 127, 129)


@pytest.mark.parametrize("n,m", [(1, 1), (129, 257), (1000, 440), (2048, 512), (8192, 512)])
def test_kernel_matches_plain(cuda_device, n, m):
    rng = np.random.RandomState(n * 7919 + m)
    a, b = words(rng, n, cuda_device), words(rng, m, cuda_device)
    before = hamming.LAUNCHES
    got = hamming.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert hamming.LAUNCHES == before + 1
    torch.testing.assert_close(got, hamming.hamming_matrix_plain(a, b), rtol=0, atol=0)


@pytest.mark.parametrize("n", TILE_EDGES)
def test_kernel_at_tile_edges(cuda_device, n):
    rng = np.random.RandomState(n)
    a = words(rng, n, cuda_device)
    for m in TILE_EDGES:
        b = words(rng, m, cuda_device)
        torch.testing.assert_close(hamming.hamming_matrix(a, b),
                                   hamming.hamming_matrix_plain(a, b), rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    rng = np.random.RandomState(1)
    a = words(rng, 64, cuda_device)
    before = hamming.LAUNCHES
    with pytest.raises(ValueError):                       # device
        hamming.hamming_matrix(a, a.cpu())
    with pytest.raises(TypeError):                        # dtype
        hamming.hamming_matrix(a, a.to(torch.int64))
    with pytest.raises(ValueError):                       # not contiguous
        hamming.hamming_matrix(a, words(rng, 64, cuda_device)[::2])
    with pytest.raises(ValueError):                       # shape: 4 words a row
        hamming.hamming_matrix(a.reshape(128, 4), a)
    with pytest.raises(ValueError):                       # shape: 3-D
        hamming.hamming_matrix(a, a[None])
    flat = a.reshape(-1)
    with pytest.raises(ValueError):                       # not 16-byte aligned
        hamming.hamming_matrix(torch.cat([flat, flat[:1]])[1:].reshape(64, 8), a)
    assert hamming.LAUNCHES == before


@pytest.mark.parametrize("n_query,n_target", chip_smoke.RADIUS_SHAPES)
@pytest.mark.parametrize("n_stages", chip_smoke.RADIUS_STAGES)
def test_radius_match_kernel_matches_plain(cuda_device, n_stages, n_query, n_target):
    rng = np.random.RandomState(n_stages * 7919 + n_query * 31 + n_target)
    case = chip_smoke.radius_case(rng, n_stages, n_query, n_target)
    args = [torch.from_numpy(np.ascontiguousarray(case[k])).to(cuda_device)
            for k in chip_smoke.TENSOR_ARGS]
    for octave_tol in (0, 1):
        before = matching.LAUNCHES
        got = matching.radius_match_stages(*args, 6, 1, octave_tol)
        torch.cuda.synchronize()
        assert matching.LAUNCHES == before + 1
        want = matching.radius_match_stages_plain(*args, 6, 1, octave_tol)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_radius_match_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    rng = np.random.RandomState(2)
    case = chip_smoke.radius_case(rng, 3, 64, 64)
    args = [torch.from_numpy(np.ascontiguousarray(case[k])).to(cuda_device)
            for k in chip_smoke.TENSOR_ARGS]

    def call(i, value):
        return matching.radius_match_stages(*args[:i], value, *args[i + 1:], 45, 1)

    with pytest.raises(ValueError):                       # a CPU tensor among CUDA ones
        call(5, args[5].cpu())
    with pytest.raises(TypeError):                        # dtype
        call(2, args[2].to(torch.int64))
    with pytest.raises(ValueError):                       # not contiguous
        call(4, torch.cat([args[4], args[4]], 1)[:, ::2])
    with pytest.raises(ValueError):                       # not 16-byte aligned
        call(4, torch.cat([args[4].reshape(-1), args[4].reshape(-1)[:1]])[1:].reshape(64, 8))
    with pytest.raises(ValueError):                       # not 8-byte aligned
        call(5, torch.cat([args[5].reshape(-1), args[5].reshape(-1)[:1]])[1:].reshape(64, 2))
    with pytest.raises(ValueError):                       # S = 5 > 4 stages
        matching.radius_match_stages(*args[:1], args[1][[0, 1, 2, 0, 1]].contiguous(),
                                     *args[2:8], args[8][[0, 1, 2, 0, 1]].contiguous(), 45, 1)


def test_slice_on_the_card_matches_stored_jax_outputs(cuda_device):
    with np.load(FIXTURE) as z:
        ref = {k: z[k] for k in z.files if k.startswith("ref_")}
    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(),
                                         (520.0, 520.0, 320.0, 240.0), 640, 480,
                                         cuda_device)
    ids = ref["ref_frame_id"][:6].tolist()
    frames = bench_world.frames(ids[0], ids[-1] + 1)
    fused, ham = matching.LAUNCHES, hamming.LAUNCHES
    for j, i in enumerate(ids):
        r = sess.process_frame(frames[j], i * 0.033, i)
        assert r.state.value == ref["ref_state"][j] and not r.is_keyframe
        assert abs(r.tracked_count - int(ref["ref_tracked"][j])) <= 3
        np.testing.assert_allclose(r.pose.R.cpu().numpy(), ref["ref_R"][j], atol=1e-3)
        np.testing.assert_allclose(r.pose.t.cpu().numpy(), ref["ref_t"][j], atol=1e-3)
    # one fused launch for the cascade and one for track-local-map a frame
    assert matching.LAUNCHES - fused == 12
    assert hamming.LAUNCHES - ham == 0


@pytest.mark.parametrize("n_a,n_b", chip_smoke.TWO_WAY_SHAPES + ((700, 1300),))
@pytest.mark.parametrize("n_batch", chip_smoke.TWO_WAY_BATCHES)
def test_two_way_kernel_matches_plain(cuda_device, n_batch, n_a, n_b):
    rng = np.random.RandomState(n_batch * 7919 + n_a * 31 + n_b)
    for shared in (False, True):
        case = chip_smoke.two_way_case(rng, n_batch, n_a, n_b, shared)
        args = [torch.from_numpy(np.ascontiguousarray(case[k])).to(cuda_device)
                for k in chip_smoke.TWO_WAY_ARGS]
        for min_diff in chip_smoke.TWO_WAY_MIN_DIFFS:
            before = matching.TWO_WAY_LAUNCHES
            got = matching.match_two_way(*args, 6, min_diff)
            torch.cuda.synchronize()
            assert matching.TWO_WAY_LAUNCHES == before + 1
            want = matching.match_two_way_plain(*args, 6, min_diff)
            for g, w in zip(got, want):
                assert g.shape == (n_batch, n_a)
                torch.testing.assert_close(g, w, rtol=0, atol=0)


def two_way_equal_to_plain(args, max_hamming, min_diff):
    before = matching.TWO_WAY_LAUNCHES
    got = matching.match_two_way(*args, max_hamming, min_diff)
    torch.cuda.synchronize()
    assert matching.TWO_WAY_LAUNCHES == before + 1
    want = matching.match_two_way_plain(*args, max_hamming, min_diff)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    return got


@pytest.mark.parametrize("n_a", TILE_EDGES)
def test_two_way_at_tile_edges(cuda_device, n_a):
    rng = np.random.RandomState(100 + n_a)
    for n_b in TILE_EDGES:
        case = chip_smoke.two_way_case(rng, 2, n_a, n_b, False)
        args = [torch.from_numpy(np.ascontiguousarray(case[k])).to(cuda_device)
                for k in chip_smoke.TWO_WAY_ARGS]
        two_way_equal_to_plain(args, 6, 1)


def eight_bits(rng):
    """(8,) uint32 words with 8 of their 256 bits set."""
    bits = np.zeros(256, np.uint8)
    bits[rng.permutation(256)[:8]] = 1
    return np.packbits(bits, bitorder="little").view(np.uint32)


def test_two_way_whole_row_and_column_tied(cuda_device):
    """Row 0 of A is at distance 8 from every column, and column 0 of B at
    distance 8 from every row: the first index must win both ways."""
    rng = np.random.RandomState(8)
    n = 300
    col0 = eight_bits(rng)
    a = np.stack([np.zeros(8, np.uint32)] + [col0 ^ eight_bits(rng) for _ in range(n - 1)])
    b = np.stack([col0] + [eight_bits(rng) for _ in range(n - 1)])
    valid_a, valid_b = np.ones((1, n), bool), np.ones((1, n), bool)
    valid_b[0, rng.permutation(np.arange(1, n))[:20]] = False
    args = [torch.from_numpy(x).to(cuda_device) for x in
            (a.view(np.int32), valid_a, b[None].view(np.int32).copy(), valid_b)]
    for min_diff in (0, 1):
        two_way_equal_to_plain(args, 20, min_diff)


def test_two_way_ties_across_chunk_and_tile_edges(cuda_device):
    """Equal best distances on either side of the scan's 256-target chunk
    edge and of its 8-column tiles: the lower index wins."""
    n_b = 600
    q = np.zeros((4, 8), np.uint32)
    t = np.full((n_b, 8), 0xFFFFFFFF, np.uint32)         # distance 256 from a zero row
    pairs = ((255, 256), (7, 8), (511, 512), (300, 599))
    for r, (lo, hi) in enumerate(pairs):
        q[r, 0] = r + 1
        t[lo] = t[hi] = q[r]
        t[lo, 0] = t[hi, 0] = q[r, 0] ^ (1 << 9)          # both at distance 1 from query r
    valid_b = np.ones((1, n_b), bool)
    args = [torch.from_numpy(x).to(cuda_device) for x in
            (q.view(np.int32), np.ones((1, 4), bool), t[None].view(np.int32).copy(), valid_b)]
    got = two_way_equal_to_plain(args, 20, 0)
    # each tied pair's columns both pick their query row, so the row's best is
    # the lower index; with min_diff 0 the forward gate passes
    assert got[0][0].tolist() == [lo for lo, _ in pairs]
    valid_b[0, [255, 7, 511, 300]] = False                # now the higher index is alone
    args[3] = torch.from_numpy(valid_b).to(cuda_device)
    got = two_way_equal_to_plain(args, 20, 0)
    assert got[0][0].tolist() == [hi for _, hi in pairs]


def test_two_way_every_target_invalid(cuda_device):
    rng = np.random.RandomState(10)
    case = chip_smoke.two_way_case(rng, 3, 130, 300, False)
    case["valid_b"][:] = False
    args = [torch.from_numpy(np.ascontiguousarray(case[k])).to(cuda_device)
            for k in chip_smoke.TWO_WAY_ARGS]
    got = two_way_equal_to_plain(args, 256, 0)
    assert (got[0] == -1).all() and (got[1] == -1).all()


def test_two_way_unbatched_and_full_range_words(cuda_device):
    rng = np.random.RandomState(5)
    a, b = words(rng, 300, cuda_device), words(rng, 200, cuda_device)
    b[:100] = a[:100] ^ 1                        # near copies: real matches
    va = torch.ones(300, dtype=torch.bool, device=cuda_device)
    vb = torch.ones(200, dtype=torch.bool, device=cuda_device)
    got = matching.match_two_way(a, va, b, vb, 45, 8)
    want = matching.match_two_way_plain(a, va, b, vb, 45, 8)
    assert got[0].shape == (300,) and int((got[0] >= 0).sum()) >= 100
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_two_way_empty_sides_launch_nothing(cuda_device):
    rng = np.random.RandomState(6)
    a = words(rng, 16, cuda_device)
    va = torch.ones(16, dtype=torch.bool, device=cuda_device)
    none = a[:0]
    before = matching.TWO_WAY_LAUNCHES
    idx, dist = matching.match_two_way(a, va, none, va[:0], 45, 8)
    assert idx.tolist() == [-1] * 16 and dist.tolist() == [-1] * 16
    idx, _ = matching.match_two_way(none, va[:0], a, va, 45, 8)
    assert idx.shape == (0,) and matching.TWO_WAY_LAUNCHES == before


def test_two_way_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    rng = np.random.RandomState(7)
    case = chip_smoke.two_way_case(rng, 2, 64, 64, False)
    args = [torch.from_numpy(np.ascontiguousarray(case[k])).to(cuda_device)
            for k in chip_smoke.TWO_WAY_ARGS]

    def call(i, value):
        return matching.match_two_way(*args[:i], value, *args[i + 1:], 45, 8)

    with pytest.raises(ValueError):                       # a CPU tensor among CUDA ones
        call(2, args[2].cpu())
    with pytest.raises(TypeError):                        # dtype
        call(1, args[1].to(torch.int32))
    with pytest.raises(ValueError):                       # shape: valid_a of another batch
        call(1, args[1][:1])
    with pytest.raises(ValueError):                       # not contiguous
        call(2, torch.cat([args[2], args[2]], 2)[:, :, ::2])
    with pytest.raises(ValueError):                       # not 16-byte aligned
        flat = args[2].reshape(-1)
        call(2, torch.cat([flat, flat[:1]])[1:].reshape(2, 64, 8))


def test_mapping_event_on_the_card_matches_the_jax_map(cuda_device):
    pre = chip_smoke.load_event(cuda_device)
    fused, two_way, ham = matching.LAUNCHES, matching.TWO_WAY_LAUNCHES, hamming.LAUNCHES
    new_map, _, ki = chip_smoke.map_event(pre)
    torch.cuda.synchronize()
    assert ki == 3
    assert chip_smoke.mask_diffs(new_map, pre[4]) == dict.fromkeys(chip_smoke.MAP_MASKS, 0)
    torch.testing.assert_close(new_map.kf_pose.t, pre[4].kf_pose.t, rtol=0,
                               atol=chip_smoke.MAP_POSE_ATOL)
    torch.testing.assert_close(new_map.mp_pos[new_map.mp_valid], pre[4].mp_pos[new_map.mp_valid],
                               rtol=0, atol=chip_smoke.MAP_POINT_ATOL)
    # the loop-closure match and five re-association matches, one two-way call
    assert matching.LAUNCHES - fused == 6
    assert matching.TWO_WAY_LAUNCHES - two_way == 1
    assert hamming.LAUNCHES - ham == 0


def tethered_problem(device, seed=0, K=6, Pn=40, O=160, Tn=6):
    """A synthetic BA problem with all three tether kinds and one empty
    tether slot, from a numpy seed."""
    from mageslam_tpu_torch.ba.problem import empty_problem
    from mageslam_tpu_torch.geometry.se3 import Pose, exp_se3

    rng = np.random.RandomState(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))           # noqa: E731
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))             # noqa: E731
    poses = exp_se3(f32(rng.randn(K, 6) * 0.05))
    points = f32(rng.uniform(-1, 1, (Pn, 3)) + [0, 0, 4])
    cam = np.tile(np.float32([520, 520, 320, 240]), (K, 1))
    obs_cam, obs_pt = rng.randint(0, K, O), rng.randint(0, Pn, O)
    Xc = torch.einsum("oij,oj->oi", poses.R[obs_cam], points[obs_pt]) + poses.t[obs_cam]
    uv = 520 * Xc[:, :2] / Xc[:, 2:] + f32([320, 240]) + f32(rng.randn(O, 2) * 0.5)
    delta = exp_se3(f32(rng.randn(Tn, 6) * 0.1))
    p = empty_problem(K, Pn, O, n_tethers=Tn, device="cpu")._replace(
        poses=poses, intrinsics=f32(cam), cam_fixed=torch.arange(K) == 0,
        cam_valid=torch.ones(K, dtype=torch.bool), points=points,
        pt_valid=torch.ones(Pn, dtype=torch.bool), obs_cam=i32(obs_cam), obs_pt=i32(obs_pt),
        obs_uv=uv, obs_info=torch.ones(O),
        tether_kind=i32(np.arange(Tn) % 3), tether_cam1=i32(rng.randint(0, K // 2, Tn)),
        tether_cam2=i32(rng.randint(K // 2, K, Tn)), tether_pose=Pose(delta.R, delta.t),
        tether_distance=f32(rng.uniform(0.2, 1, Tn)),
        tether_weight=f32(np.where(np.arange(Tn) == Tn - 1, 0, 2.0)))
    return type(p)(*(Pose(x.R.to(device), x.t.to(device)) if isinstance(x, Pose)
                     else x.to(device) if isinstance(x, torch.Tensor) else x for x in p))


def test_tether_residuals_on_the_card_match_the_cpu(cuda_device):
    from mageslam_tpu_torch.ba import residuals

    on_card = tethered_problem(cuda_device)
    on_cpu = tethered_problem("cpu")
    got = residuals.tether_residuals(on_card, on_card.poses)
    want = residuals.tether_residuals(on_cpu, on_cpu.poses)
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == torch.float32 and g.is_cuda, name
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4, msg=name)
    assert float(got.Jc1.abs().max()) > 0.1 and float(got.chi2.max()) > 0


def test_bundle_adjust_with_tethers_on_the_card_matches_the_cpu(cuda_device):
    from mageslam_tpu_torch.ba import problem, step

    out = []
    for device in (cuda_device, "cpu"):
        p = tethered_problem(device)
        st, _, outliers = step.step_bundle_adjust(p, problem.BAState.from_problem(p),
                                                  [1.5, 1.2, 1.0], 9.0)
        out.append((st.poses.t.cpu(), st.points.cpu(), outliers.cpu(), p.poses.t.cpu()))
    (t_a, x_a, o_a, t0), (t_b, x_b, o_b, _) = out
    torch.testing.assert_close(t_a, t_b, rtol=0, atol=1e-4)
    torch.testing.assert_close(x_a, x_b, rtol=0, atol=1e-3)
    assert torch.equal(o_a, o_b)
    assert float((t_a - t0).abs().max()) > 1e-3           # the poses moved


def test_mapping_event_with_a_live_tether_on_the_card(cuda_device):
    """The map's tether bank reaches local BA on the card: a heavy distance
    tether between two window keyframes moves the mapped poses, as on the
    CPU."""
    from mageslam_tpu_torch import golden_path_settings as settings
    from mageslam_tpu_torch.runtime.mapping_step import mapping

    maps = []
    for device in (cuda_device, torch.device("cpu")):
        pre_map, pre_ph, frame, map_scale, _ = chip_smoke.load_event(device)
        n = pre_map.tether_weight.shape[0]
        weight = torch.zeros(n, device=device)
        weight[0] = 50.0
        tethered = pre_map._replace(
            tether_origin=torch.full_like(pre_map.tether_origin, 1),
            tether_owner=torch.full_like(pre_map.tether_owner, 2),
            tether_distance=torch.full_like(pre_map.tether_distance, 3.0),
            tether_weight=weight)
        free = mapping(settings(), 640, 480, pre_map, pre_ph, frame, map_scale)[0]
        held = mapping(settings(), 640, 480, tethered, pre_ph, frame, map_scale)[0]
        assert not torch.allclose(held.kf_pose.t, free.kf_pose.t, atol=1e-3)
        maps.append(held)
    torch.testing.assert_close(maps[0].kf_pose.t.cpu(), maps[1].kf_pose.t, rtol=0, atol=1e-3)
    assert torch.equal(maps[0].kf_valid.cpu(), maps[1].kf_valid)
