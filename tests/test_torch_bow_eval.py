"""The port's bag-of-words scale evaluation (mageslam_tpu_torch/apps/bow_eval.py)
against the JAX package's (mageslam_tpu/apps/bow_eval.py) on a small cut
committed in tests/data/torch_port_diag.npz (`python tools/export_jax_state.py
diag`): 3 rooms of 8 keyframe views, a query every 4th view, ±2 views
correct; the JAX frontend's descriptors of every view and query, the Gumbel
draws of both vocabularies, the four metrics and every query's top-4 list.
From the same descriptors and draws the port's vocabulary, IDF, index and
queries give the same metrics and the same top-4 lists, exactly.

The full-size run (3 rooms × 70 views, 36 queries) renders for minutes and
is held on the card by chip_smoke.py against the fixture's `bf_*` result.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import os

import numpy as np
import pytest
import torch

from mageslam_tpu_torch.apps import bow_eval

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIAG = os.path.join(REPO, "tests", "data", "torch_port_diag.npz")
VOCABS = ("all_rooms_vocab", "room0_vocab")
METRICS = ("top1", "p_at_4", "qual_recall", "cross_room")


@pytest.fixture(scope="module")
def cut():
    with np.load(DIAG) as z:
        ref = {k: z[k] for k in z.files if k.startswith("bc_")}
    views, _, tol = ref["bc_config"].tolist()
    queries = [(int(r), float(p), torch.from_numpy(d.view(np.int32)), torch.from_numpy(v))
               for r, p, d, v in zip(ref["bc_q_room"], ref["bc_q_phase"], ref["bc_q_desc"],
                                     ref["bc_q_valid"])]
    out = bow_eval.evaluate(torch.from_numpy(ref["bc_kf_desc"].view(np.int32)),
                            torch.from_numpy(ref["bc_kf_valid"]), queries, views, tol=tol,
                            draws={v: ref[f"bc_{v}_draws"] for v in VOCABS}, verbose=False)
    return ref, out


@pytest.mark.parametrize("vocab", VOCABS)
def test_metrics_and_top4_equal_jax(cut, vocab):
    ref, out = cut
    got = out[vocab]
    assert [got[m] for m in METRICS] == ref[f"bc_{vocab}_metrics"].tolist()
    np.testing.assert_array_equal(got["top4"], ref[f"bc_{vocab}_top4"])
    assert out["keyframes"] == len(ref["bc_kf_desc"]) == 24 and out["queries"] == 6


def test_pools_are_the_reference_slices(cut):
    ref, _ = cut
    kd = torch.from_numpy(ref["bc_kf_desc"].view(np.int32))
    kv = torch.from_numpy(ref["bc_kf_valid"])
    pools = bow_eval.vocabulary_pools(kd, kv, 8)
    assert pools["all_rooms_vocab"][0].shape == (4 * 512, 8)     # views 0, 7, 14, 21
    assert pools["room0_vocab"][0].shape == (4 * 512, 8)         # room 0's views 0, 2, 4, 6
    for v in VOCABS:
        assert ref[f"bc_{v}_draws"].shape == (pools[v][0].shape[0],)
    torch.testing.assert_close(pools["all_rooms_vocab"][0][512:1024], kd[7])
