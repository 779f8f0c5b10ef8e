"""The port's `radius_match_stages` against the JAX package's radius_match.

On the CPU `radius_match_stages` is its plain PyTorch version: it is held
exactly (idx and dist) against JAX `ops/matching.radius_match`, run once per
stage, on chip_smoke.py's edge-case inputs (low-entropy descriptors with
ties at best and second, integer positions and radii with targets exactly
on the box edge, invalid and far-away rows). The fused CUDA kernel against
the plain version runs only where a GPU is present: tests/test_torch_cuda.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mageslam_tpu.ops import matching as jmatch
from mageslam_tpu_torch.ops import matching

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

BIG = 1 << 20


def port_args(case):
    return [torch.from_numpy(np.ascontiguousarray(case[k])) for k in chip_smoke.TENSOR_ARGS]


def jax_per_stage(case, max_hamming, min_diff, octave_tol):
    """JAX radius_match once per stage: (S, Q) idx and dist."""
    fixed = {k: jnp.asarray(case[k]) for k in ("query_octave", "query_valid", "target_xy",
                                               "target_octave", "target_valid")}
    q_desc = jnp.asarray(case["query_desc"].view(np.uint32))
    t_desc = jnp.asarray(case["target_desc"].view(np.uint32))
    out = [jmatch.radius_match(
        q_desc, jnp.asarray(case["query_xy"][s]), fixed["query_octave"],
        fixed["query_valid"], t_desc, fixed["target_xy"], fixed["target_octave"],
        fixed["target_valid"], jnp.asarray(case["radius"][s]), jnp.int32(max_hamming),
        jnp.int32(min_diff), octave_tol=octave_tol) for s in range(len(case["radius"]))]
    return (np.stack([np.asarray(i) for i, _ in out]),
            np.stack([np.asarray(d) for _, d in out]))


# (max_hamming, min_diff) at the gate's edges: nothing but exact copies;
# distances equal to the limit; ties at best accepted (min_diff -1); a
# max_hamming past BIG, where a row with no candidate reads (0, BIG)
GATES = [(0, 0), (6, 1), (256, -1), (BIG, 2)]


@pytest.mark.parametrize("gate", GATES, ids=lambda g: f"mh{g[0]}-md{g[1]}")
@pytest.mark.parametrize("octave_tol", [0, 1])
@pytest.mark.parametrize("n_stages", [1, 3])
def test_radius_match_stages_plain_matches_jax(n_stages, octave_tol, gate):
    rng = np.random.RandomState(100 * n_stages + 10 * octave_tol + GATES.index(gate))
    case = chip_smoke.radius_case(rng, n_stages, 150, 120)
    got_idx, got_dist = matching.radius_match_stages(*port_args(case), *gate, octave_tol)
    want_idx, want_dist = jax_per_stage(case, *gate, octave_tol)
    assert got_idx.shape == got_dist.shape == (n_stages, 150)
    assert got_idx.dtype == got_dist.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_array_equal(got_dist.numpy(), want_dist)
    # the case reaches every edge the kernel must get right
    stats = chip_smoke.case_stats(dict(zip(chip_smoke.TENSOR_ARGS, port_args(case))),
                                  octave_tol)
    assert min(stats.values()) > 0, stats
    if gate == (6, 1):
        assert (got_idx.numpy() >= 0).sum() > 5


def test_radius_match_is_the_one_stage_case():
    rng = np.random.RandomState(7)
    case = chip_smoke.radius_case(rng, 1, 90, 200)
    args = port_args(case)
    args[1] = args[1][0]                           # (Q, 2) query positions
    got = matching.radius_match(*args[:8], 4.0, 6, 1)
    want_idx, want_dist = jax_per_stage({**case, "radius": np.full((1, 90), 4.0, np.float32)},
                                        6, 1, 0)
    np.testing.assert_array_equal(got[0].numpy(), want_idx[0])
    np.testing.assert_array_equal(got[1].numpy(), want_dist[0])


@pytest.mark.parametrize("max_hamming", [45, BIG])
def test_no_valid_target(max_hamming):
    """Every target invalid: no row has a candidate, so every stage gives
    (-1, -1), or (0, BIG) where max_hamming reaches BIG, as JAX does."""
    rng = np.random.RandomState(3)
    case = chip_smoke.radius_case(rng, 3, 40, 30)
    case["target_valid"] = np.zeros(30, bool)
    got_idx, got_dist = matching.radius_match_stages(*port_args(case), max_hamming, 1, 1)
    want_idx, want_dist = jax_per_stage(case, max_hamming, 1, 1)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_array_equal(got_dist.numpy(), want_dist)


def test_empty_target_set():
    """T = 0 (JAX's argmin refuses an empty row): every stage gives (-1, -1)."""
    rng = np.random.RandomState(4)
    case = chip_smoke.radius_case(rng, 3, 20, 0)
    idx, dist = matching.radius_match_stages(*port_args(case), BIG, 1, 0)
    assert idx.shape == dist.shape == (3, 20)
    assert (idx.numpy() == -1).all() and (dist.numpy() == -1).all()


def test_cuda_tensor_never_takes_the_plain_path():
    """A tensor that is not on the CPU gets the kernel or an error; a mix
    raises instead of falling back (a meta tensor needs no GPU)."""
    rng = np.random.RandomState(5)
    args = port_args(chip_smoke.radius_case(rng, 1, 8, 8))
    args[4] = args[4].to("meta")
    with pytest.raises(ValueError):
        matching.radius_match_stages(*args, 45, 1)
