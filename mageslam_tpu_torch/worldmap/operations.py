"""Map mutations: keyframe insertion, map point creation and removal,
culling (port of mageslam_tpu/worldmap/operations.py; Map/Map.cpp and
ThreadSafeMap.cpp as masked scatters and gathers over the banks).

Every function returns a new MapState and reads nothing back to the host:
slots and counts stay tensors.
"""

from __future__ import annotations

import torch

from ..geometry.se3 import Pose
from ..ops.indexing import any_drop, pair_index, set_drop
from .map_state import MapState, point_keyframe_matrix, point_octave_histogram
from .member_index import fidx_remove_keyframes, fidx_remove_points


def row_of(bank: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """bank[k] for a 0-d index tensor, without a host read."""
    return bank.index_select(0, k.reshape(1))[0]


def _slot_writer(ok: torch.Tensor, s: torch.Tensor):
    """wr(bank, value): `bank` with row s (1,) set to value where ok, left
    as it is where not."""
    def wr(bank, value):
        value = torch.as_tensor(value, dtype=bank.dtype, device=bank.device)
        value = torch.where(ok, value, bank.index_select(0, s)[0])
        return bank.index_put((s,), value[None])
    return wr


def insert_keyframe(state: MapState, pose: Pose, cam, frame_id, kp_xy, kp_octave,
                    desc, kp_valid, assoc, fixed=False, immortal=False):
    """ThreadSafeMap::InsertKeyframe. Returns (state, slot); the slot is a
    0-d int32 tensor, -1 (and the write dropped) when the bank is full."""
    free = ~state.kf_valid
    slot = torch.argmax(free.to(torch.int32)).to(torch.int32)    # first free slot
    ok = torch.any(free)
    s = torch.where(ok, slot, 0).reshape(1)

    # only associate to currently valid points
    assoc_ok = (assoc >= 0) & state.mp_valid[torch.where(assoc >= 0, assoc, 0)]
    assoc_clean = torch.where(assoc_ok, assoc, -1)

    wr = _slot_writer(ok, s)
    new = state._replace(
        kf_valid=wr(state.kf_valid, True),
        kf_fixed=wr(state.kf_fixed, fixed),
        kf_immortal=wr(state.kf_immortal, immortal),
        kf_pose=Pose(wr(state.kf_pose.R, pose.R), wr(state.kf_pose.t, pose.t)),
        kf_cam=wr(state.kf_cam, cam),
        kf_frame_id=wr(state.kf_frame_id, frame_id),
        kf_order=wr(state.kf_order, state.next_order),
        kf_kp_xy=wr(state.kf_kp_xy, kp_xy),
        kf_kp_octave=wr(state.kf_kp_octave, kp_octave),
        kf_desc=wr(state.kf_desc, desc),
        kf_kp_valid=wr(state.kf_kp_valid, kp_valid),
        kf_assoc=wr(state.kf_assoc, assoc_clean),
        next_order=state.next_order + ok.to(torch.int32),
    )
    return new, torch.where(ok, slot, -1)


def create_map_points(state: MapState, pos, desc, kf_a, feat_a, kf_b, feat_b, want):
    """Map::CreateMapPoints: allocate point slots for the wanted rows (in
    row order, lowest free slot first), write positions and descriptors,
    associate into both observing keyframes. Returns (state, (M,) slots or
    -1). The (keyframe, feature) pairs of the wanted rows must be distinct."""
    P = state.mp_valid.shape[0]
    K, N = state.kf_assoc.shape
    free = ~state.mp_valid
    n_free = torch.sum(free.to(torch.int32))
    rank = torch.cumsum(want.to(torch.int32), dim=0) - 1
    ok = want & (rank < n_free)
    free_order = torch.argsort((~free).to(torch.int8), stable=True)  # free slots first
    slots = free_order[torch.clamp(rank, 0, P - 1)].to(torch.int32)
    slots_w = torch.where(ok, slots, P)
    slots_safe = torch.where(ok, slots, 0)

    new = state._replace(
        mp_valid=set_drop(state.mp_valid, slots_w, True),
        mp_pos=set_drop(state.mp_pos, slots_w, pos),
        mp_desc=set_drop(state.mp_desc, slots_w, desc),
        mp_refine_count=set_drop(state.mp_refine_count, slots_w, 0),
        mp_created_order=set_drop(state.mp_created_order, slots_w,
                                  (state.next_order - 1).expand(slots_w.shape)),
        mp_found=set_drop(state.mp_found, slots_w, 1),
        mp_predicted=set_drop(state.mp_predicted, slots_w, 1),
    )
    assoc = new.kf_assoc.reshape(-1)
    assoc = set_drop(assoc, torch.where(ok, pair_index(kf_a, feat_a, K, N), -1),
                     slots_safe)
    assoc = set_drop(assoc, torch.where(ok, pair_index(kf_b, feat_b, K, N), -1),
                     slots_safe)
    return new._replace(kf_assoc=assoc.reshape(K, N)), torch.where(ok, slots_safe, -1)


def remove_map_points(state: MapState, remove: torch.Tensor) -> MapState:
    """Invalidate the points flagged in `remove` (P,) bool and clear every
    association that references them."""
    assoc = state.kf_assoc
    hit = (assoc >= 0) & remove[torch.where(assoc >= 0, assoc, 0)]
    return state._replace(mp_valid=state.mp_valid & ~remove,
                          kf_assoc=torch.where(hit, -1, assoc))


def merge_map_points(state: MapState, src: torch.Tensor, dst: torch.Tensor,
                     want: torch.Tensor) -> MapState:
    """Map::MergeMapPoints: retarget every association of src to dst, then
    remove src. A keyframe observes a point at most once: where a keyframe
    already observes dst, the retargeted association is dropped (an
    unchanged association beats a retargeted one, then the lower feature
    index wins). src, dst, want are (M,) batches."""
    P = state.mp_valid.shape[0]
    srcs = torch.where(want, src, P)
    redirect = set_drop(torch.arange(P, dtype=torch.int32, device=src.device), srcs,
                        dst.to(torch.int32))
    assoc = state.kf_assoc
    new_assoc = torch.where(assoc >= 0, redirect[torch.where(assoc >= 0, assoc, 0)], assoc)
    N = assoc.shape[1]
    changed = new_assoc != assoc
    eq = (new_assoc[:, :, None] == new_assoc[:, None, :]) & (new_assoc[:, None, :] >= 0)
    earlier = torch.tril(torch.ones((N, N), dtype=torch.bool, device=src.device), -1)
    preferred = ((changed[:, :, None] & ~changed[:, None, :])
                 | ((changed[:, :, None] == changed[:, None, :]) & earlier[None]))
    dup = torch.any(eq & preferred, dim=-1)
    return state._replace(kf_assoc=torch.where(dup, -1, new_assoc),
                          mp_valid=state.mp_valid & ~any_drop(P, srcs, want))


def add_keyframe_tether(state: MapState, owner, origin, kind, pose: Pose,
                        distance=1.0, weight=1.0) -> MapState:
    """Persist a constraint between two keyframes (Data/Tether.h:12-68) in
    the first free tether slot; every BA window holding both keyframes
    assembles it (worldmap/ba_window.py). Dropped when the bank is full.
    `pose` is the measured origin→owner delta T_owner ∘ T_origin⁻¹."""
    free = state.tether_weight <= 0
    ok = torch.any(free)
    wr = _slot_writer(ok, torch.where(ok, torch.argmax(free.to(torch.int32)), 0).reshape(1))
    return state._replace(
        tether_owner=wr(state.tether_owner, owner),
        tether_origin=wr(state.tether_origin, origin),
        tether_kind=wr(state.tether_kind, kind),
        tether_pose=Pose(wr(state.tether_pose.R, pose.R), wr(state.tether_pose.t, pose.t)),
        tether_distance=wr(state.tether_distance, distance),
        tether_weight=wr(state.tether_weight, weight),
    )


def remove_keyframes(state: MapState, remove: torch.Tensor,
                     fidx: torch.Tensor | None = None):
    """Invalidate the keyframes flagged in `remove` (K,) bool and clear their
    association rows; points left with fewer than 2 observers are removed
    (ThreadSafeMap.cpp:1139-1150), and tethers of a removed keyframe die
    with it. With `fidx` the observer recount reads it, and (state, fidx)
    is returned."""
    t_dead = (remove[torch.where(state.tether_owner >= 0, state.tether_owner, 0)]
              | remove[torch.where(state.tether_origin >= 0, state.tether_origin, 0)])
    state = state._replace(
        kf_valid=state.kf_valid & ~remove,
        kf_assoc=torch.where(remove[:, None], -1, state.kf_assoc),
        tether_weight=torch.where(t_dead, 0.0, state.tether_weight),
    )
    if fidx is None:
        n_obs = torch.sum(point_keyframe_matrix(state).to(torch.int32), dim=0)
        return remove_map_points(state, state.mp_valid & (n_obs < 2))
    fidx = fidx_remove_keyframes(fidx, remove)
    n_obs = torch.sum((fidx >= 0).to(torch.int32), dim=0)
    orphan = state.mp_valid & (n_obs < 2)
    return remove_map_points(state, orphan), fidx_remove_points(fidx, orphan)


def cull_recent_map_points(state: MapState, ki, failed,
                           min_keyframes_for_culling: int = 3,
                           recent_window: int = 3,
                           fidx: torch.Tensor | None = None):
    """ThreadSafeMap::CullRecentMapPoints: a recently created point must earn
    `min_keyframes_for_culling` observing keyframes by its second insertion
    after creation (age >= 2) and pass the found/predicted test (`failed`,
    at every age 1-3), else it is removed, unless the current keyframe `ki`
    (a 0-d index tensor) sees it. With `fidx`, returns (state, fidx)."""
    member = point_keyframe_matrix(state) if fidx is None else (fidx >= 0)
    n_obs = torch.sum(member.to(torch.int32), dim=0)
    age = (state.next_order - 1) - state.mp_created_order
    recent = state.mp_valid & (age >= 0) & (age <= recent_window)
    under_observed = recent & (age >= 2) & (n_obs < min_keyframes_for_culling)
    to_cull = (under_observed | (recent & failed)) & ~row_of(member, ki)
    if fidx is None:
        return remove_map_points(state, to_cull)
    return remove_map_points(state, to_cull), fidx_remove_points(fidx, to_cull)


def cull_local_keyframes(state: MapState, ki, covis, num_levels: int,
                         covis_theta: int = 15,
                         max_tracking_point_overlap: float = 0.9,
                         min_keyframe_covis_count: int = 3, max_culls: int = 8,
                         fidx: torch.Tensor | None = None):
    """ThreadSafeMap::CullLocalKeyframes: a covisible keyframe is redundant
    when at least 90 % of its map points are observed at an equal or finer
    scale by at least 3 other keyframes. The newest redundant keyframe is
    culled and the rest re-evaluated against the updated map, up to
    `max_culls` times. The reference loops while a victim exists; here the
    loop always takes `max_culls` masked turns, because the stop condition
    lives on the device and a turn without a victim changes nothing.
    Returns (state, culled (K,) bool), and fidx too when it is passed."""
    K, P, N = state.capacity
    dev = state.kf_valid.device
    k_ids = torch.arange(K, device=dev)
    connected = row_of(covis, ki) >= covis_theta

    def find_victim(st: MapState):
        hist = point_octave_histogram(st, num_levels)              # (P, L)
        cum = torch.cumsum(hist, dim=1)                            # obs at level <= l
        candidate = connected & st.kf_valid & ~st.kf_immortal & (k_ids != ki)
        a_ok = (st.kf_assoc >= 0) & st.kf_kp_valid
        safe = torch.where(a_ok, st.kf_assoc, 0)
        octv = torch.clamp(st.kf_kp_octave, 0, num_levels - 1)
        seen_fine = cum.reshape(-1)[safe.to(torch.int64) * num_levels + octv]
        well_observed = a_ok & ((seen_fine - 1) >= min_keyframe_covis_count)
        n_points = torch.sum(a_ok.to(torch.int32), dim=1)
        n_well = torch.sum(well_observed.to(torch.int32), dim=1)
        redundant = candidate & (n_points > 0) & (
            n_well.to(torch.float32)
            >= max_tracking_point_overlap * n_points.to(torch.float32))
        # newest first (ThreadSafeMap.cpp:1077-1080)
        victim = torch.argmax(torch.where(redundant, st.kf_order, -1))
        return victim, torch.any(redundant)

    culled = torch.zeros((K,), dtype=torch.bool, device=dev)
    victim, any_v = find_victim(state)
    for _ in range(max_culls):
        cull_mask = (k_ids == victim) & any_v
        if fidx is None:
            state = remove_keyframes(state, cull_mask)
        else:
            state, fidx = remove_keyframes(state, cull_mask, fidx=fidx)
        culled = culled | cull_mask
        victim, any_v = find_victim(state)
    if fidx is None:
        return state, culled
    return state, culled, fidx
