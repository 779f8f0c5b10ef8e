"""The port on an NVIDIA GPU: the CUDA kernels (standalone Hamming, fused
radius match with its dedup, fused two-way match, bag-of-words word
assignment and k-medoid iteration) against their plain versions, the
tracking slice and the first mapping event against the stored JAX outputs,
local BA with live tethers against the same run on the CPU, the vocabulary
against the CPU, mono init from frame 0 against the JAX session, and
relocalization, loop detection and closure, the photoreal run's first
frames with a snapshot restored against the stored JAX outputs, and the
visual-inertial path: the fuser's float32 products, its three filters
replayed on the JAX run's inputs, the VI session's first 26 frames and the
fossilized map's queries; and the throughput and realtime entry points:
the stream and pipelined calls against JAX's, the realtime gate, a disk
snapshot continued on the card; and the diagnostics: the state digest
kernel against its plain version and JAX's column, and a Determinator
replay of the stream on the card; and the two cluster kernels (local_best,
the digest) exact right after a refused launch and from two streams at
once; and three pyramid levels (the pyramid against the CPU's, the session
from frame 0 and a relocalization against JAX's) and the FUSER3DOF and
FUSER6DOF sessions against JAX's (chip_smoke.py phase 16).

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false. This file imports no JAX, so on a machine with a GPU and no JAX
it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import os
import sys

import numpy as np
import pytest
import torch

from mageslam_tpu_torch import SlamSession, bench_world, golden_path_settings
from mageslam_tpu_torch.ops import bow_words, hamming, matching

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
        for group in (None, max(n_query // 4, 1)):
            before = matching.LAUNCHES
            got = matching.radius_match_stages(*args, 6, 1, octave_tol, group)
            torch.cuda.synchronize()
            assert matching.LAUNCHES == before + 1
            want = matching.radius_match_stages_plain(*args, 6, 1, octave_tol, group)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)


def dedup_args(device, n_stages, n_query, n_target):
    case = chip_smoke.dedup_case(np.random.RandomState(n_query + n_target), n_stages,
                                 n_query, n_target)
    return [torch.from_numpy(np.ascontiguousarray(case[k])).to(device)
            for k in chip_smoke.TENSOR_ARGS]


@pytest.mark.parametrize("n_stages", chip_smoke.RADIUS_STAGES)
@pytest.mark.parametrize("n_query,n_target,group", chip_smoke.DEDUP_CASES)
def test_fused_dedup_at_its_edges(cuda_device, n_stages, n_query, n_target, group):
    """Tied best claims, claims on targets past Q + 2, relocalization's
    groups: the fused kernel equals the match then the eager dedup."""
    args = dedup_args(cuda_device, n_stages, n_query, n_target)
    got = matching.radius_match_stages(*args, 256, -1, 0, group)
    want = matching.radius_match_stages_plain(*args, 256, -1, 0, group)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # again on the same scratch: the kernel left it zero
    again = matching.radius_match_stages(*args, 256, -1, 0, group)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_fused_dedup_with_nothing_to_match(cuda_device):
    """Q = 0 launches nothing; T = 0 gives -1 everywhere, deduplicated."""
    args = dedup_args(cuda_device, 3, 40, 30)
    before = matching.LAUNCHES
    idx, dist = matching.radius_match_stages(
        args[0][:0], args[1][:, :0].contiguous(), args[2][:0], args[3][:0], *args[4:8],
        args[8][:, :0].contiguous(), 45, 1, 0)
    assert idx.shape == (3, 0) and matching.LAUNCHES == before
    idx, dist = matching.radius_match_stages(*args[:4], args[4][:0], args[5][:0], args[6][:0],
                                             args[7][:0], args[8], 45, 1, 0)
    assert bool((idx == -1).all()) and bool((dist == -1).all())


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
    assert hamming.LAUNCHES - ham == 0     # no keyframe, so no bag-of-words add


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


@pytest.mark.parametrize("rows", chip_smoke.BOW_ASSIGN_ROWS + (0, 1, 17))
@pytest.mark.parametrize("low", [False, True])
def test_bow_assign_matches_plain(cuda_device, rows, low):
    """The word-assignment kernel at the path's row counts and the tile's
    edges, full-range and low-entropy words (ties at the best anchor)."""
    rng = np.random.RandomState(rows + low)
    desc, valid, anchors = chip_smoke.bow_tensors(chip_smoke.bow_case(rng, rows, 64, low),
                                                  cuda_device)
    before = bow_words.ASSIGN_LAUNCHES
    got = bow_words.assign(desc, valid, anchors)
    torch.cuda.synchronize()
    assert bow_words.ASSIGN_LAUNCHES == before + (rows > 0)
    torch.testing.assert_close(got, bow_words.assign_plain(desc, valid, anchors),
                               rtol=0, atol=0)


@pytest.mark.parametrize("rows,note", [(1024, ""), (7680, ""), (7680, "low"), (0, ""),
                                       (700, "invalid"), (700, "empty word")])
def test_bow_vocab_step_matches_plain(cuda_device, rows, note):
    """The k-medoid kernel, 12 iterations chained, against its plain version
    after each: the pools' sizes, ties, no row, an all-invalid pool, an
    anchor that no row joins."""
    rng = np.random.RandomState(rows + len(note))
    desc, valid, anchors = chip_smoke.bow_tensors(
        chip_smoke.bow_case(rng, rows, 64, note == "low"), cuda_device)
    if note == "invalid":
        valid = torch.zeros_like(valid)
    if note == "empty word":
        anchors[7] = anchors[3]
    got = want = anchors
    before = bow_words.STEP_LAUNCHES
    for _ in range(12):
        got = bow_words.vocab_step(desc, valid, got)
        want = bow_words.vocab_step_plain(desc, valid, want)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bow_words.STEP_LAUNCHES == before + 12


def test_bow_wrappers_reject_what_the_kernels_cannot_take(cuda_device):
    rng = np.random.RandomState(3)
    desc, valid, anchors = chip_smoke.bow_tensors(chip_smoke.bow_case(rng, 64), cuda_device)
    for fn in (bow_words.assign, bow_words.vocab_step):
        with pytest.raises(ValueError):                   # a CPU tensor among CUDA ones
            fn(desc, valid.cpu(), anchors)
        with pytest.raises(ValueError):                   # 65 anchors
            fn(desc, valid, torch.cat([anchors, anchors[:1]]))
        with pytest.raises(TypeError):                    # valid not bool
            fn(desc, valid.to(torch.int32), anchors)
        with pytest.raises(ValueError):                   # not 16-byte aligned
            fn(torch.cat([desc.reshape(-1), desc.reshape(-1)[:1]])[1:].reshape(64, 8), valid,
               anchors)


@pytest.mark.parametrize("n,m", [(512, 64), (1024, 64), (7680, 64), (8192, 64), (24576, 64)])
def test_kernel_at_bag_of_words_shapes(cuda_device, n, m):
    """The standalone kernel at the shapes the bag-of-words path gives it:
    a keyframe's words, the adoption's pool, the retrain's pool, a
    bank-size pool and all keyframes' histograms at once."""
    rng = np.random.RandomState(n + m)
    a, b = words(rng, n, cuda_device), words(rng, m, cuda_device)
    torch.testing.assert_close(hamming.hamming_matrix(a, b), hamming.hamming_matrix_plain(a, b),
                               rtol=0, atol=0)


def test_vocabulary_training_on_the_card_matches_the_cpu(cuda_device):
    """train_vocabulary (12 k-medoid launches) and the index built from it,
    on the card and on the CPU from the same inputs: anchors exact."""
    from mageslam_tpu_torch.bow import index, vocab

    rng = np.random.RandomState(5)
    desc = words(rng, 1024, "cpu")
    valid = torch.from_numpy(rng.rand(1024) < 0.9)
    draws = torch.from_numpy(rng.gumbel(size=1024).astype(np.float32))
    before = (hamming.LAUNCHES, bow_words.STEP_LAUNCHES)
    got = vocab.train_vocabulary(desc.to(cuda_device), valid.to(cuda_device),
                                 draws.to(cuda_device))
    assert (hamming.LAUNCHES, bow_words.STEP_LAUNCHES) == (before[0], before[1] + 12)
    want = vocab.train_vocabulary(desc, valid, draws)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    idx = index.empty_index(4)._replace(anchors=want)
    idx_gpu = index.BowIndex(*(t.to(cuda_device) for t in idx))
    a = index.add_keyframe(index.compute_idf(idx_gpu, desc.to(cuda_device),
                                             valid.to(cuda_device)), 1,
                           desc[:512].to(cuda_device), valid[:512].to(cuda_device))
    b = index.add_keyframe(index.compute_idf(idx, desc, valid), 1, desc[:512], valid[:512])
    for g, w in zip(a, b):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-6)


def test_init_from_frame_0_on_the_card_matches_the_cpu(cuda_device):
    """A bare session on the card over frames 0-8 with the JAX session's
    draws replayed: the same anchor, adoption frame and vocabulary as on
    the CPU, R within 1e-3, t within 1e-3 in the JAX session's scale."""
    from mageslam_tpu_torch.runtime.draws import ReplayDraws

    init_fixture = os.path.join(REPO, "tests", "data", "torch_port_bench640_init.npz")
    with np.load(init_fixture) as z:
        ref = {k: z[k] for k in z.files}
    sess = SlamSession(golden_path_settings(), (520.0, 520.0, 320.0, 240.0), 640, 480,
                       cuda_device, draws=ReplayDraws.from_npz(init_fixture, cuda_device))
    two_way = matching.TWO_WAY_LAUNCHES
    results = [sess.process_frame(img, i * 0.033, i)
               for i, img in enumerate(bench_world.frames(0, 9))]
    adopt = int(ref["init_adopt_frame"])
    assert [r.state.name for r in results] == ["INITIALIZING"] * adopt + ["TRACKING"] * (9 - adopt)
    # the counter on frames 1-7, the three attempts' pair matches, one third-frame check
    assert matching.TWO_WAY_LAUNCHES - two_way == adopt + 3 + 1
    np.testing.assert_array_equal(sess.bow.anchors.cpu().numpy().view(np.uint32),
                                  ref["init_bow_adopt_anchors"])
    a = int(ref["init_n_attempt"]) - 1
    R, t = ref[f"init_att{a}_pose2_R"], ref[f"init_att{a}_pose2_t"]
    k = float(np.linalg.norm(R.T @ t)) / sess.map_scale
    assert abs(k - 1) <= 0.05
    for r in results[adopt:]:
        j = r.frame_id
        assert abs(r.tracked_count - int(ref["init_ref_tracked"][j])) <= 3
        np.testing.assert_allclose(r.pose.R.cpu().numpy(), ref["init_ref_R"][j], atol=1e-3)
        np.testing.assert_allclose(k * r.pose.t.cpu().numpy(), ref["init_ref_t"][j], atol=1e-3)


def _reloc_fixture():
    with np.load(chip_smoke.RELOC_FIXTURE) as z:
        return {k: z[k] for k in z.files}


def test_relocalize_on_the_card_matches_jax(cuda_device):
    """The reloc fixture's successful relocalization, its B = 4 two-way
    match and stacked rematch launched once each."""
    from mageslam_tpu_torch.interop import unflatten
    from mageslam_tpu_torch.runtime.reloc_step import reloc_kwargs
    from mageslam_tpu_torch.tracking.frame_state import TrackedFrame
    from mageslam_tpu_torch.tracking.relocalization import relocalize
    from mageslam_tpu_torch.worldmap.map_state import MapState

    ref = _reloc_fixture()
    m = unflatten(MapState, "relocin_map", ref, cuda_device)
    frame = unflatten(TrackedFrame, "relocin_frame", ref, cuda_device)
    before = (matching.LAUNCHES, matching.TWO_WAY_LAUNCHES)
    r = relocalize(frame, m, torch.from_numpy(ref["relocin_cand"]).to(cuda_device),
                   torch.from_numpy(ref["relocin_cand_ok"]).to(cuda_device),
                   torch.from_numpy(ref["relocin_draws"]).to(cuda_device),
                   **reloc_kwargs(golden_path_settings()))
    torch.cuda.synchronize()
    assert (matching.LAUNCHES, matching.TWO_WAY_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert bool(r.succeeded) and int(r.candidate) == int(ref["relocin_out_candidate"])
    np.testing.assert_array_equal(r.assoc.cpu().numpy(), ref["relocin_out_assoc"])
    np.testing.assert_allclose(r.pose.R.cpu().numpy(), ref["relocin_out_R"], atol=1e-4)
    np.testing.assert_allclose(r.pose.t.cpu().numpy(), ref["relocin_out_t"], atol=1e-4)


def test_lost_session_relocalizes_on_the_card(cuda_device):
    ref = _reloc_fixture()
    run = chip_smoke.run_reloc(cuda_device, ref)
    first = chip_smoke.RELOC_SNAP_FRAME + 1
    assert [r.state.value for r in run["results"]] == ref["ref_state"][first:].tolist()
    assert not any(run["draws"].remaining().values())
    for lost, got in run["launches"]:
        assert got == (chip_smoke.LAUNCHES_RELOC if lost else chip_smoke.LAUNCHES_TRACKED)


@pytest.mark.parametrize("s", ["a", "b"])
def test_loop_detection_and_closure_on_the_card_match_jax(cuda_device, s):
    from mageslam_tpu_torch.interop import unflatten
    from mageslam_tpu_torch.runtime.loop_closure import detect_loop
    from mageslam_tpu_torch.worldmap.map_state import MapState

    with np.load(chip_smoke.LOOP_FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    m, bow, frame = chip_smoke.loop_scene(ref, s, cuda_device)
    det, _, _ = detect_loop(m, bow, frame, 5,
                            lambda: torch.from_numpy(ref[f"{s}_draws"]).to(cuda_device),
                            min_keyframes=5, min_cluster_size=2)
    assert bool(det.detected)
    np.testing.assert_array_equal(det.cluster_mask.cpu().numpy(), ref[f"{s}_det_cluster_mask"])
    np.testing.assert_array_equal(det.reloc_assoc.cpu().numpy(), ref[f"{s}_det_reloc_assoc"])
    assert abs(float(det.scale) - float(ref[f"{s}_det_scale"])) < 1e-5
    sess = chip_smoke.closure_session(cuda_device, m, 5)
    assert sess._apply_loop_closure(det, frame, 5)
    want = unflatten(MapState, f"{s}_gba", ref, cuda_device)
    assert not any(chip_smoke.mask_diffs(sess.map, want).values())
    assert chip_smoke.aligned_error(sess.map, want) < chip_smoke.CLOSURE_ATOL


def test_snapshot_restore_on_the_card(cuda_device):
    """Photoreal frames 0-11 (init at 5, keyframes at 6, 7, 11) on the
    card, JAX draws replayed: a snapshot after frame 4, the frames run,
    the snapshot restored and the frames run again give the same results
    and the same map."""
    from mageslam_tpu_torch.interop import to_numpy
    from mageslam_tpu_torch.runtime.draws import ReplayDraws

    with np.load(chip_smoke.PHOTOREAL_FIXTURE) as z:
        frames, ts, cam = z["frames"][:12], z["timestamps"][:12], z["cam"]
        want_state = z["ref_state"][:12]
    sess = SlamSession(golden_path_settings(), cam, *chip_smoke.PHOTOREAL_SIZE, cuda_device,
                       draws=ReplayDraws.from_npz(chip_smoke.PHOTOREAL_FIXTURE, cuda_device))
    for i in range(5):
        sess.process_frame(frames[i], float(ts[i]), i)
    snap = sess.snapshot_state()
    first = [sess.process_frame(frames[i], float(ts[i]), i) for i in range(5, 12)]
    map1 = to_numpy(sess.map)
    sess.restore_state(snap)
    again = [sess.process_frame(frames[i], float(ts[i]), i) for i in range(5, 12)]
    assert [r.state.value for r in first] == want_state[5:].tolist()
    for a, b in zip(first, again):
        assert (a.state, a.tracked_count, a.is_keyframe) == (b.state, b.tracked_count,
                                                           b.is_keyframe)
        assert torch.equal(a.pose.R, b.pose.R) and torch.equal(a.pose.t, b.pose.t)
    for name, x in to_numpy(sess.map).items():
        np.testing.assert_array_equal(x, map1[name], err_msg=name)


def test_fuser_products_on_the_card_keep_float32(cuda_device):
    """The filter's update on the card: its 15×15 products run in full
    float32 (TF32 off), so the Joseph-form covariance agrees with a float64
    evaluation to float32 rounding (TF32 keeps ~3 digits)."""
    from mageslam_tpu_torch.fuser import filters

    assert torch.backends.cuda.matmul.allow_tf32 is False
    rng = np.random.default_rng(3)
    q = rng.normal(size=4)
    A = rng.normal(scale=0.1, size=(15, 15))
    leaves = [q / np.linalg.norm(q), rng.normal(size=3), rng.normal(size=3),
              rng.normal(scale=1e-2, size=3), rng.normal(scale=1e-1, size=3),
              A @ A.T + 1e-2 * np.eye(15)]
    H, r = rng.normal(size=(6, 15)), rng.normal(size=6)
    B = rng.normal(size=(6, 6))
    Rm = 0.1 * (B @ B.T + np.eye(6))
    state = filters.EkfState(*[torch.tensor(x, dtype=torch.float32, device=cuda_device)
                               for x in leaves])
    got = filters._kalman(state, *[torch.tensor(x, dtype=torch.float32, device=cuda_device)
                                   for x in (H, r, Rm)])
    P = np.asarray(leaves[5], np.float32).astype(np.float64)
    H64, Rm64 = (np.asarray(x, np.float32).astype(np.float64) for x in (H, Rm))
    K = P @ H64.T @ np.linalg.inv(H64 @ P @ H64.T + Rm64)
    IKH = np.eye(15) - K @ H64
    want = IKH @ P @ IKH.T + K @ Rm64 @ K.T
    assert float(np.abs(got.P.cpu().numpy() - want).max() / np.abs(want).max()) < 1e-5


def test_fuser_replays_on_the_card_match_jax(cuda_device):
    """The three filters replayed on the card on the JAX VI run's samples
    and visual poses (chip_smoke.py phase 12's check)."""
    ref = chip_smoke.load_npz(chip_smoke.VI_FIXTURE)
    out = chip_smoke.check_replays(cuda_device, ref, chip_smoke.vi_samples(ref))
    assert out["FUSER3DOF"]["scale"] is None and out["SIMPLE6DOF"]["scale"] > 0


def test_vi_window_on_the_card_matches_jax(cuda_device):
    """tests/test_torch_vi.py's window (frames 0-25: adoption at 5,
    SCALE_INIT at 6, TRACKING at 17, IMU priors from 18) on the card, JAX
    draws replayed: the fuser's modes, states, keyframe flags and poses."""
    from mageslam_tpu_torch.apps.vi_eval import run_vi_eval

    ref = chip_smoke.load_npz(chip_smoke.VI_FIXTURE)
    with np.load(chip_smoke.PHOTOREAL_FIXTURE) as z:
        frames = z["frames"][:26]
    out = run_vi_eval(26, period=80, verbose=False, device=cuda_device,
                      draws=chip_smoke.vi_draws(cuda_device), frames=frames)
    assert out["transitions"] == {"WAIT_FOR_GRAVITY": 5, "SCALE_INIT": 6, "TRACKING": 17}
    sess = out["session"]
    k = float(ref["map_scale"]) / sess.map_scale
    want = {n: ref[f"ref_{n}"] for n in ("state", "is_kf", "tracked", "R", "t")}
    for j, r in enumerate(sess.results):
        err, d_count = chip_smoke.frame_error(r, want, j, k)
        assert err <= chip_smoke.POSE_ATOL and d_count <= chip_smoke.TRACKED_TOL, (j, err)
    assert abs(out["metric_scale"] / k / float(ref["metric_scale"][17]) - 1) <= 1e-3


def test_fossilized_map_on_the_card_matches_jax(cuda_device):
    """FossilizedMap and the live queries on the JAX photoreal session's end
    state, on the card: trajectory, volume of interest and the denoised
    cloud (its normals' signs are the card's solver's: within 2e-3 of the
    cloud's extent)."""
    from mageslam_tpu_torch import interop
    from mageslam_tpu_torch.runtime.fossilized import FossilizedMap
    from mageslam_tpu_torch.runtime.pose_history import PoseHistory
    from mageslam_tpu_torch.worldmap.map_state import MapState

    photo = chip_smoke.load_npz(chip_smoke.PHOTOREAL_FIXTURE)
    ref = chip_smoke.load_npz(chip_smoke.VI_FIXTURE)
    m = interop.unflatten(MapState, "final_map", photo, cuda_device)
    ph = interop.unflatten(PoseHistory, "pr_ph", ref, cuda_device)
    fm = FossilizedMap(m, ph, golden_path_settings().MonoSettings.MonoCamera
                       .FeatureExtractorSettings)
    ids, mats = fm.trajectory()
    np.testing.assert_array_equal(ids, np.flatnonzero(ref["pr_live_has"]))
    np.testing.assert_allclose(mats, ref["pr_live_mats"][ref["pr_live_has"]], atol=1e-5)
    raw = fm.map_points()
    np.testing.assert_array_equal(raw, ref["pr_fm_points_raw"])
    extent = float(np.ptp(raw, axis=0).max())
    np.testing.assert_allclose(fm.map_points(denoised=True), ref["pr_fm_points"], rtol=0,
                               atol=2e-3 * extent)
    np.testing.assert_allclose(np.stack(fm.try_get_volume_of_interest()), ref["pr_fm_voi"],
                               atol=1e-4)
    sess = SlamSession(golden_path_settings(), photo["cam"], *chip_smoke.PHOTOREAL_SIZE,
                       cuda_device)
    sess.map, sess.pose_history, sess.initialized = m, ph, True
    np.testing.assert_allclose(np.stack(sess.try_get_volume_of_interest()),
                               ref["pr_live_voi"], atol=1e-4)


def test_vi_run_on_the_card_matches_jax(cuda_device):
    """The whole 80-frame VI run on the card (chip_smoke.py phase 12's
    measured run): the fuser's modes, every frame, the metric scale, the
    priors and covariances and the masks as JAX's, with photoreal frame
    71's borderline inliers held to their logged ceilings (ROADMAP queue
    3)."""
    from mageslam_tpu_torch.apps.vi_eval import vi_settings

    ref = chip_smoke.load_npz(chip_smoke.VI_FIXTURE)
    photo = chip_smoke.load_npz(chip_smoke.PHOTOREAL_FIXTURE)
    rec, maps, faults = {}, [], []
    run = chip_smoke.run_from_frame0(
        cuda_device, list(photo["frames"]), chip_smoke.vi_draws(cuda_device),
        [chip_smoke.map_recorder(maps), *chip_smoke.vi_recorders(rec)], cam=ref["cam"],
        size=chip_smoke.PHOTOREAL_SIZE, timestamps=photo["timestamps"],
        settings=vi_settings(), feed=chip_smoke.vi_feed(chip_smoke.vi_samples(ref)))
    held = chip_smoke.check_vi_run(run, rec, maps, ref, faults)
    assert not faults, faults
    assert held["over"] == [] or [f for f, _ in held["over"]] == [71]


# ------------------------------------------------- stream entry points ----

def stream_bank(device, last: int):
    frames = chip_smoke.render_window(0, last + 1)
    return (torch.from_numpy(np.stack(frames)).to(device),
            [i * chip_smoke.DT for i in range(last + 1)], list(range(last + 1)))


def test_stream_on_the_card_matches_jax(cuda_device):
    """`process_frame_stream` over bench frames 31-71 on the card (chunk 8,
    depth 4, a uint8 bank on the card) against the JAX stream call: states,
    keyframes, poses (1e-3), tracked counts (3), the masks after each
    mapping step and `loop_det_stats`, with every kernel of the path
    launched and the standalone Hamming kernel never."""
    ref = chip_smoke.load_npz(chip_smoke.STREAM_FIXTURE)
    bank, ts, ids = stream_bank(cuda_device, 71)
    sess = chip_smoke.stream_session(cuda_device, "s71_")
    events, faults = [], []
    chip_smoke.reset_launch_counts()
    with chip_smoke.Patched(*chip_smoke.stream_event_recorder(events)):
        res = sess.process_frame_stream(bank, ts, ids, start=31, stop=72, chunk=8)
    counts = chip_smoke.counted_launches()
    assert all(counts[k] for k in chip_smoke.STREAM_KERNELS) and not counts["hamming_matrix"]
    chip_smoke.hold_stream(res, ref, "s71_", range(31, 72), faults, events)
    assert not faults, faults
    assert [sess.loop_det_stats[k] for k in chip_smoke.DET_STATS] == \
        ref["s71_det_stats"].tolist()


def test_pipelined_on_the_card_matches_jax(cuda_device):
    ref = chip_smoke.load_npz(chip_smoke.STREAM_FIXTURE)
    bank, ts, ids = stream_bank(cuda_device, 58)
    sess = chip_smoke.stream_session(cuda_device, "p58_")
    events, faults = [], []
    with chip_smoke.Patched(*chip_smoke.stream_event_recorder(events)):
        for i in range(31, 59):
            sess.process_frame_pipelined(bank[i], ts[i], i)
        sess.flush()
    chip_smoke.hold_stream(sess.results, ref, "p58_", range(31, 59), faults, events)
    assert not faults, faults


def test_realtime_gate_on_the_card(cuda_device):
    """Paced frames all track; with max_inflight=0 every frame drops as
    SKIPPED and the lost count stays; dispatches resolve once their
    events have passed."""
    from mageslam_tpu_torch import TrackingState

    bank, ts, _ = stream_bank(cuda_device, 43)
    sess = chip_smoke.stream_session(cuda_device, None)
    for i in range(31, 39):
        sess.process_frame_realtime(bank[i], ts[i], i)
        sess.flush()
    assert all(r.state == TrackingState.TRACKING for r in sess.results)
    lost = sess.lost_count
    drops = [sess.process_frame_realtime(bank[i], ts[i], i, max_inflight=0)
             for i in range(39, 43)]
    assert all(r.state == TrackingState.SKIPPED for r in drops) and sess.lost_count == lost
    sess.process_frame_realtime(bank[43], ts[43], 43)
    torch.cuda.synchronize()
    assert all(event.query() for *_, event in sess._pending)
    sess.flush()
    assert sess.results[-1].state == TrackingState.TRACKING


def test_disk_snapshot_on_the_card_continues_the_run(cuda_device, tmp_path):
    """Chunks over 31-46 on the card, the session saved to disk, loaded into
    a fresh card session and continued over 47-62: the uninterrupted run's
    results; the file loads on the CPU leaf for leaf."""
    from mageslam_tpu_torch import interop
    from mageslam_tpu_torch.io.snapshot import load_session_snapshot, save_session_snapshot

    bank, ts, ids = stream_bank(cuda_device, 62)
    whole = chip_smoke.stream_session(cuda_device, None)
    want = whole.process_frame_stream(bank, ts, ids, start=31, stop=63, chunk=8)
    sess = chip_smoke.stream_session(cuda_device, None)
    got = sess.process_frame_stream(bank, ts, ids, start=31, stop=47, chunk=8)
    path = str(tmp_path / "snap.npz")
    save_session_snapshot(path, sess)
    fresh = SlamSession(chip_smoke.stream_settings(), chip_smoke.CAM, chip_smoke.WIDTH,
                        chip_smoke.HEIGHT, cuda_device)
    load_session_snapshot(path, fresh)
    fresh._chunk_pipeline_depth = chip_smoke.STREAM_DEPTH
    got += fresh.process_frame_stream(bank, ts, ids, start=47, stop=63, chunk=8)
    faults = []
    chip_smoke.same_results(got, want, "continued from disk", faults)
    assert not faults, faults
    cpu = SlamSession(chip_smoke.stream_settings(), chip_smoke.CAM, chip_smoke.WIDTH,
                      chip_smoke.HEIGHT, "cpu")
    load_session_snapshot(path, cpu, restore_draws=False)   # a card generator's state
    for a, b in ((sess.map, cpu.map), (sess.bow, cpu.bow)):     # the state saved
        for name, x in interop.to_numpy(a).items():
            assert np.array_equal(x, interop.to_numpy(b)[name], equal_nan=True), name


def test_state_digest_matches_plain_and_jax(cuda_device):
    """The digest kernel equals its plain version, on the card and on the
    CPU, on every case of chip_smoke.py phase 14 (the JAX stream call's
    inputs with JAX's value, all-zero, all-NaN-bit, full banks, one
    keyframe and no point), launching once a call."""
    from mageslam_tpu_torch.ops import digest

    ref = chip_smoke.load_npz(chip_smoke.DIAG_FIXTURE)
    for name, case in chip_smoke.digest_cases(ref).items():
        args = chip_smoke.digest_args(case, cuda_device)
        n0 = digest.LAUNCHES
        got = digest.state_digest(*args)
        assert digest.LAUNCHES == n0 + 1 and got.dtype == torch.float32 and got.shape == (1,)
        want = {float(digest.state_digest_plain(*args)[0]),
                float(digest.state_digest(*chip_smoke.digest_args(case, "cpu"))[0])}
        if "digest" in case:
            want.add(float(case["digest"]))
        assert want == {float(got[0])}, name


def test_state_digest_is_exact_right_after_a_refused_launch(cuda_device):
    """Launches the C entry point refuses before any kernel runs (a negative
    count, a bank past its limit) report an error, a call the wrapper
    refuses raises, and the next call is exact. This covers refusals only:
    a kernel that faults once started leaves the CUDA context unusable, so
    no test here can follow one with another call."""
    from mageslam_tpu_torch.ops import _build, digest

    args = chip_smoke.digest_args(chip_smoke.synthetic_digest_cases()["full"], cuda_device)
    out = torch.empty((1,), device=cuda_device)
    stream = torch._C._cuda_getCurrentRawStream(cuda_device.index)
    for n_points, n_keyframes in ((-1, 256), (8192, -1), (1 << 27, 256)):
        assert _build.library().mageslam_state_digest(
            *(t.data_ptr() for t in args), out.data_ptr(), n_points, n_keyframes, stream) != 0
        got = digest.state_digest(*args)
        assert float(got[0]) == float(digest.state_digest_plain(*args)[0])
    with pytest.raises(ValueError):
        digest.state_digest(args[0], args[1].cpu(), *args[2:])
    got = digest.state_digest(*args)
    assert float(got[0]) == float(digest.state_digest_plain(*args)[0])


def test_state_digest_rejects_what_the_kernel_cannot_take(cuda_device):
    from mageslam_tpu_torch.ops import digest

    pos = torch.zeros((8, 3), device=cuda_device)
    t = torch.zeros((2, 3), device=cuda_device)
    mv = torch.zeros(8, dtype=torch.bool, device=cuda_device)
    kv = torch.zeros(2, dtype=torch.bool, device=cuda_device)
    fsk = torch.zeros((), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        digest.state_digest(pos.double(), t, mv, kv, fsk)
    with pytest.raises(ValueError):
        digest.state_digest(pos.T.contiguous().T, t, mv, kv, fsk)
    with pytest.raises(ValueError):
        digest.state_digest(pos, t, mv, kv, torch.zeros(2, dtype=torch.int32,
                                                           device=cuda_device))
    with pytest.raises(ValueError):
        digest.state_digest(pos, t.cpu(), mv, kv, fsk)


def test_determinator_replays_the_stream_on_the_card(cuda_device):
    """Two runs of the stream window 31-71 on the card from the fixture's
    state, the second verifying against the first's recording: every
    checkpoint (the chunk summaries with their digest column, the
    detections, the tail frame's) bit-identical, one digest launch a chunk
    frame, and the names those of the JAX stream call's prefix."""
    from mageslam_tpu_torch.diagnostics import Determinator
    from mageslam_tpu_torch.ops import digest

    bank, ts, ids = stream_bank(cuda_device, 71)

    def run(det):
        sess = chip_smoke.stream_session(cuda_device, "s71_")
        sess.determinator = det
        return sess.process_frame_stream(bank, ts, ids, start=31, stop=72, chunk=8)

    first = Determinator()
    n0 = digest.LAUNCHES
    run(first)
    assert digest.LAUNCHES - n0 == 40          # five chunks of 8 frames
    again = Determinator()
    again._expected = list(first._stream)
    run(again)
    assert again.is_deterministic, again.divergences[:4]
    assert again._cursor == len(first._stream) > 5
    assert {n for n, _ in first._stream} >= {"Stream.Chunk", "LoopClosure.Detect"}


# ------------------------------------------------- parallel and offload ----

def test_local_best_kernel_matches_plain(cuda_device):
    """local_best.cu on chip_smoke.py's cases (the path's shapes, ties
    inside and across blocks, a column tied over every row, no valid row,
    every cell gated out, ragged rows): one launch a call, all three outputs
    exactly the plain version's."""
    from mageslam_tpu_torch.ops import local_best

    for name, case, radius, max_h in chip_smoke.local_best_cases(np.random.RandomState(15)):
        args = chip_smoke.lb_tensors(case, cuda_device)
        before = local_best.LAUNCHES
        got = local_best.local_best(*args, radius, max_h)
        torch.cuda.synchronize()
        assert local_best.LAUNCHES == before + 1
        for g, w in zip(got, local_best.local_best_plain(*args, radius, max_h)):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def test_local_best_is_exact_right_after_a_refused_launch(cuda_device):
    """Launches the C entry point refuses before any kernel runs (no row, a
    bank past the keys' 22 row bits, no target) report an error, the
    wrapper raises ValueError on a bank past the row bits, and the next call
    is exact. This covers refusals only: a kernel that faults once started
    leaves the CUDA context unusable, so no test here can follow one with
    another call."""
    from mageslam_tpu_torch.ops import _build, local_best

    args = chip_smoke.lb_tensors(chip_smoke.shard_case(2048), cuda_device)
    out = torch.empty((3, 512), dtype=torch.int32, device=cuda_device)
    stream = torch._C._cuda_getCurrentRawStream(cuda_device.index)
    want = local_best.local_best_plain(*args, 12.0, 45)
    for n_query, n_target in ((0, 512), (1 << 22, 512), (2048, 0)):
        assert _build.library().mageslam_local_best(
            *(t.data_ptr() for t in args), *(o.data_ptr() for o in out), 12.0, 45, n_query,
            n_target, stream) != 0
        for g, w in zip(local_best.local_best(*args, 12.0, 45), want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    rows = 1 << 22
    big = (torch.zeros((rows, 8), dtype=torch.int32, device=cuda_device),
           torch.zeros((rows, 2), device=cuda_device),
           torch.ones(rows, dtype=torch.bool, device=cuda_device))
    with pytest.raises(ValueError, match="22 bits"):
        local_best.local_best(*big, *args[3:], 12.0, 45)
    del big
    for g, w in zip(local_best.local_best(*args, 12.0, 45), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_cluster_kernels_agree_across_two_streams_at_once(cuda_device):
    """local_best and the digest launched from two threads, each on its own
    CUDA stream, at once (as the mapping offload's worker launches beside
    the main thread): every answer equals the plain version's."""
    import threading

    from mageslam_tpu_torch.ops import digest, local_best

    lb = chip_smoke.lb_tensors(chip_smoke.shard_case(4096), cuda_device)
    cases = chip_smoke.synthetic_digest_cases()
    dg = [chip_smoke.digest_args(cases[k], cuda_device) for k in ("full", "unaligned_rows")]
    lb_want = local_best.local_best_plain(*lb, 12.0, 45)
    dg_want = [float(digest.state_digest_plain(*a)[0]) for a in dg]
    torch.cuda.synchronize()
    outs = [[], []]

    def launch(out: list) -> None:
        stream = torch.cuda.Stream(cuda_device)
        with torch.cuda.stream(stream):
            for i in range(64):
                out.append((local_best.local_best(*lb, 12.0, 45), digest.state_digest(*dg[i % 2])))
        stream.synchronize()

    workers = [threading.Thread(target=launch, args=(out,)) for out in outs]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    torch.cuda.synchronize()
    for out in outs:
        assert len(out) == 64
        for i, (got, d) in enumerate(out):
            for g, w in zip(got, lb_want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
            assert float(d[0]) == dg_want[i % 2]


def test_local_best_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    from mageslam_tpu_torch.ops import local_best

    args = chip_smoke.lb_tensors(chip_smoke.matcher_case(512, 128), cuda_device)
    with pytest.raises(TypeError):
        local_best.local_best(args[0].to(torch.int64), *args[1:], 12.0, 45)
    with pytest.raises(ValueError):
        local_best.local_best(args[0][:, :4].contiguous(), *args[1:], 12.0, 45)
    with pytest.raises(ValueError):
        local_best.local_best(args[0][:0], args[1][:0], args[2][:0], *args[3:], 12.0, 45)
    with pytest.raises(ValueError):
        local_best.local_best(args[0], args[1].cpu(), *args[2:], 12.0, 45)


def test_sharded_matcher_on_copies_of_the_card(cuda_device):
    """The sharded matcher over 4 copies of the card: JAX's answers."""
    from mageslam_tpu_torch.parallel import make_session_mesh, make_sharded_guided_matcher

    with np.load(chip_smoke.PARALLEL_FIXTURE) as z:
        want = {k: z[k] for k in ("mt_small_d8", "mt_full_d8")}
    match = make_sharded_guided_matcher(make_session_mesh([cuda_device] * 4, "model"))
    for size, (P, N) in (("small", (512, 128)), ("full", (8192, 512))):
        args = chip_smoke.lb_tensors(chip_smoke.matcher_case(P, N), cuda_device)
        got = match(*args, *chip_smoke.MATCH_GATES)
        np.testing.assert_array_equal(got.cpu().numpy(), want[f"mt_{size}_d8"])


def test_offload_on_a_second_stream_follows_jax(cuda_device):
    """Frames 31-60 with the mapping offloaded to a second stream of the
    card, then fossilize(0): states, keyframe flags, poses and tracked
    counts as JAX's offloaded session; every pass adopted."""
    with np.load(chip_smoke.PARALLEL_FIXTURE) as z:
        ref = {f"ref_{k[4:]}": z[k][:30] for k in ("off_frame_id", "off_R", "off_t",
                                                    "off_tracked", "off_is_kf", "off_state")}
    frames = chip_smoke.render_window(31, 61)
    results, _, adoptions, sess, _ = chip_smoke.offload_session(cuda_device, frames, True)
    chip_smoke.check_window(results, ref)
    assert [f for f, _ in adoptions] == [r.frame_id for r in results if r.is_keyframe]
    assert sess._offload_stream is not None and sess._offload_pending is None


# --------------------------------------- three levels, the other filters ----

def test_pyramid_on_the_card_equals_the_cpu(cuda_device):
    """The three-level pyramid on the card equals the CPU's and JAX's (as
    tests/data/torch_port_levels.npz records it) bit for bit at 640x480,
    320x180 and 160x120."""
    chip_smoke.check_pyramid(cuda_device)


def test_levels_session_on_the_card_matches_jax(cuda_device):
    """The three-level session from frame 0 on bench frames 0-51 (chip_smoke.py
    phase 16): states, keyframe flags, poses (1e-3, t scaled), tracked
    counts and octave histograms (3), the masks after each mapping event,
    the launches of each frame's class; every kernel call exact, some of
    the radius matches on octaves other than 0."""
    calls, faults = [], []
    chip_smoke.hold_levels_session(cuda_device, calls, faults)
    assert not faults, faults
    chip_smoke.hold_path_calls(calls, "the three-level session")
    assert chip_smoke.octave_calls(calls)["radius"][1] > 0


def test_levels_relocalization_on_the_card_matches_jax(cuda_device):
    """tests/test_bow_reloc.py's scene at three levels from the JAX state
    after frame 29: lost, relocalized at 35 as JAX."""
    calls, faults = [], []
    chip_smoke.check_levels_reloc(cuda_device, calls, faults)
    assert not faults, faults
    chip_smoke.hold_path_calls(calls, "the three-level relocalization")


@pytest.mark.parametrize("prefix,name", chip_smoke.VI_FILTER_RUNS)
def test_vi_filter_session_on_the_card_matches_jax(cuda_device, prefix, name):
    """The 80-frame VI session under FUSER3DOF / FUSER6DOF on the card
    against the JAX run: modes, frames, scale, priors, covariances, filter
    state and masks, photoreal frame 71's borderline inliers held to their
    logged ceilings (ROADMAP queue 3)."""
    calls, faults = [], []
    chip_smoke.run_vi_filter(cuda_device, prefix, name, calls, faults)
    assert not faults, faults
