"""Port vs JAX reference: semi-global aggregation and winner-take-all.

The plain versions run here; the reference runs both as its XLA path (exact
scans, chunk=None) and as the TPU kernel chain sgm_wta_pallas in interpret
mode. Integer outputs are bit-exact and the f32 disparity is equal (same f32
operations in the same order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu.ops import disparity as RD
from stereo_reconstruction_cv_tpu.ops.pallas.sgm_pallas import sgm_aggregate_pallas, sgm_wta_pallas
from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK

P1, P2 = 8 * 3 * 121, 32 * 3 * 121


def _volume(seed, shape=(24, 40, 16), hi=20000):
    return np.random.default_rng(seed).integers(0, hi, size=shape).astype(np.int16)


@pytest.mark.parametrize("ndirs", [5, 8])
def test_sgm_aggregate_matches_reference(ndirs):
    C = _volume(ndirs)
    dirs = RD.DIRS_5 if ndirs == 5 else RD.DIRS_8
    ref = np.asarray(RD.sgm_aggregate(jnp.asarray(C), P1, P2, dirs, None, 32))
    got = SK.sgm_aggregate(torch.from_numpy(C), P1, P2, SK.directions_for(ndirs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("min_disp,ratio", [(0, 10), (3, 10), (0, 0)])
def test_wta_matches_reference(min_disp, ratio):
    # A narrow cost range makes ties and near-ties (uniqueness) common.
    S = np.random.default_rng(7).integers(0, 60, size=(20, 33, 16)).astype(np.int32)
    disp_r, valid_r = RD.wta_disparity(jnp.asarray(S), min_disp, ratio)
    disp, valid, best, minS = SK.wta_maps(torch.from_numpy(S), min_disp, ratio)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(disp_r))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_r))
    d2, v2 = SK.wta_disparity(torch.from_numpy(S), min_disp, ratio)
    assert torch.equal(d2, disp) and torch.equal(v2, valid)
    np.testing.assert_array_equal(best.numpy(), np.argmin(S, axis=-1))
    np.testing.assert_array_equal(minS.numpy(), S.min(axis=-1))


@pytest.mark.parametrize("ndirs,min_disp", [(5, 3), (8, 0)])
def test_sgm_wta_matches_pallas_interpret(ndirs, min_disp):
    """The port's plain chain == the TPU kernels, run in interpret mode."""
    C = _volume(10 + ndirs, (24, 32, 16))
    ref = sgm_wta_pallas(jnp.asarray(C), P1, P2, ndirs, 10, min_disp, interpret=True)
    got = SK.sgm_wta(torch.from_numpy(C), P1, P2, ndirs, 10, min_disp)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("ndirs", [5, 8])
def test_kernel_split_composes_to_the_whole(ndirs):
    """The pieces the two kernels compute (grouped path deltas, then the fused
    last sweep + WTA) compose to the whole aggregation."""
    C = torch.from_numpy(_volume(20 + ndirs, (13, 29, 24)))
    ga, gb = SK.delta_groups(ndirs)
    assert len(ga) <= 4 and len(gb) <= 4 and SK.FUSED_DIR not in ga + gb
    assert sorted(ga + gb + [SK.FUSED_DIR]) == sorted(SK.directions_for(ndirs))
    partial = sum(SK.path_delta_plain(C, dx, dy, P1, P2) for dx, dy in ga + gb)
    got = SK.sweep_wta_plain(C, partial, ndirs, P1, P2, 10, 2)
    ref = SK.sgm_wta_plain(C, P1, P2, ndirs, 10, 2)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    # Each direction's delta lies in [0, P2]: four of them fit one u16 volume.
    d = SK.path_delta_plain(C, 1, 1, P1, P2)
    assert int(d.min()) >= 0 and int(d.max()) <= P2


# Direction lists by case; the 5- and 8-path lists keep the ids "5" and "8".
AGGREGATE_LISTS = {
    5: SK.DIRS_5,
    8: SK.DIRS_8,
    "one direction": ((1, -1),),
    "no FUSED_DIR": ((1, 0), (-1, -1), (1, -1), (-1, 0)),
    "duplicate": ((1, 0), (0, 1), (1, 0), (-1, 1), (0, 1)),
}


def _aggregate_by_passes(C, dirs):
    """sgm_aggregate_cuda's decomposition in plain PyTorch: per pass of
    aggregate_passes, the u16 volumes of its groups, then sweep_sum_plain
    over its fused direction (added onto the earlier passes' S)."""
    S = torch.zeros(C.shape, dtype=torch.int32)
    for fused, groups in SK.aggregate_passes(dirs):
        assert len(groups) <= 2 and all(1 <= len(g) <= 4 for g in groups)
        partial = torch.zeros_like(S)
        for g in groups:
            vol = sum(SK.path_delta_plain(C, dx, dy, P1, P2) for dx, dy in g)
            assert int(vol.max()) <= 0xFFFF
            partial += vol
        S += SK.sweep_sum_plain(C, partial, 1 + sum(map(len, groups)), P1, P2, fused)
    return S


@pytest.mark.parametrize("case", list(AGGREGATE_LISTS))
def test_aggregate_groups_compose_to_the_whole(case):
    """What sgm_aggregate_cuda computes: u16 volumes of every direction but
    the fused one (FUSED_DIR where the list holds it, else its last entry;
    duplicates summed), then the fused sweep storing S. Equal to the
    reference's sgm_aggregate (exact scans) and, for 5 and 8 paths, to
    sgm_aggregate_pallas in interpret mode."""
    dirs = AGGREGATE_LISTS[case]
    Cn = _volume(40 + len(dirs), (11, 23, 24))
    C = torch.from_numpy(Cn)
    (fused, groups), = SK.aggregate_passes(dirs)
    assert fused == (SK.FUSED_DIR if SK.FUSED_DIR in dirs else dirs[-1])
    assert sorted([fused, *(d for g in groups for d in g)]) == sorted(dirs)
    S = _aggregate_by_passes(C, dirs)
    ref = np.asarray(RD.sgm_aggregate(jnp.asarray(Cn), P1, P2, dirs, None, 32))
    np.testing.assert_array_equal(S.numpy(), ref)
    if len(dirs) in (5, 8) and set(dirs) == set(SK.directions_for(len(dirs))):
        pal = sgm_aggregate_pallas(jnp.asarray(Cn), P1, P2, len(dirs), interpret=True)
        np.testing.assert_array_equal(S.numpy(), np.asarray(pal))
    assert torch.equal(S, SK.sgm_aggregate(C, P1, P2, dirs))


def test_aggregate_passes_of_a_long_list_add_up():
    """Past SUM_PASS directions the fused sweep runs once per pass, each
    after volumes of at most four, and adds onto S; an empty list is 0."""
    dirs = SK.DIRS_8 + SK.DIRS_5 + ((0, 1),)
    passes = SK.aggregate_passes(dirs)
    assert [1 + sum(map(len, g)) for _, g in passes] == [SK.SUM_PASS, len(dirs) - SK.SUM_PASS]
    Cn = _volume(47, (9, 14, 24))
    C = torch.from_numpy(Cn)
    S = _aggregate_by_passes(C, dirs)
    ref = np.asarray(RD.sgm_aggregate(jnp.asarray(Cn), P1, P2, dirs, None, 32))
    np.testing.assert_array_equal(S.numpy(), ref)
    assert SK.aggregate_passes(()) == []
    assert not SK.sgm_aggregate(C, P1, P2, ()).any()


def test_aggregate_refuses_what_the_kernels_refuse():
    C = torch.from_numpy(_volume(48, (11, 23, 24)))
    dirs = SK.DIRS_8
    # One check for both devices: the CPU refuses what the kernels refuse.
    with pytest.raises(ValueError, match="unit steps"):
        SK.sgm_aggregate(C, P1, P2, [(2, 0)])
    with pytest.raises(ValueError, match="65535"):
        SK.sgm_aggregate(C, P1, 16384, dirs)
    with pytest.raises(ValueError, match="CUDA"):
        SK.sgm_aggregate_cuda(C, P1, P2, dirs)


def test_bounds_and_cpu_dispatch():
    with pytest.raises(ValueError, match="65535"):
        SK.check_sgm_bounds(P1, 16384, 128, 5)
    with pytest.raises(ValueError):
        SK.check_sgm_bounds(P1, P2, 128, 6)
    C = torch.from_numpy(_volume(30, (6, 9, 16)))
    before = dict(SK.launches)
    SK.sgm_wta(C, P1, P2, 8, 10, 0)
    assert SK.launches == before


@pytest.mark.parametrize("D,k", [(1, 1), (17, 1), (32, 1), (33, 2), (64, 2), (100, 4),
                                 (128, 4), (129, 8), (256, 8), (257, 16), (512, 16)])
def test_lanes_k_covers_d_with_32_lanes(D, k):
    assert SK.lanes_k(D) == k
    assert 32 * k >= D and (k == 1 or 16 * k < D)


@pytest.mark.parametrize("D,ptrs,vec", [
    (128, (0, 4096), True),       # K = 4: 8-byte accesses
    (128, (2, 4096), False),      # C 2 bytes off an 8-byte boundary
    (128, (8, 4104), True),
    (256, (16, 32), True),        # K = 8: 16-byte accesses
    (256, (8, 32), False),
    (512, (16, 48), True),        # K = 16: two 16-byte accesses, 16-byte aligned
    (100, (0, 0), True),          # 100 = 25 lanes x 4
    (33, (0, 0), False),          # K = 2, 33 % 2 != 0
    (17, (2, 6), True),           # K = 1: every int16 is aligned
    (1, (2, 6), True),
])
def test_sweep_vector_path_choice(D, ptrs, vec):
    assert SK.sweep_vector_path(D, *ptrs) is vec


@functools.lru_cache(maxsize=None)
def _fused_case(ndirs):
    """C, the plain maps and the reference TPU chain's maps (interpret mode)."""
    C = _volume(60 + ndirs, (21, 27, 16))
    ref = sgm_wta_pallas(jnp.asarray(C), P1, P2, ndirs, 10, 1, interpret=True)
    plain = SK.sgm_wta_plain(torch.from_numpy(C), P1, P2, ndirs, 10, 1)
    return torch.from_numpy(C), plain, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("ndirs,direction",
                         [(5, d) for d in SK.DIRS_5] + [(8, d) for d in SK.DIRS_8])
def test_any_fused_direction_gives_the_same_maps(ndirs, direction):
    """S is a sum of integers, so whichever direction the fused sweep + WTA
    runs last, with the others' deltas summed beforehand, the four maps are
    the same bits: those of the plain chain and of sgm_wta_pallas."""
    C, plain, ref = _fused_case(ndirs)
    ga, gb = SK.delta_groups(ndirs, direction)
    assert len(ga) <= 4 and len(gb) <= 4 and direction not in ga + gb
    assert sorted(ga + gb + [direction]) == sorted(SK.directions_for(ndirs))
    partial = sum(SK.path_delta_plain(C, dx, dy, P1, P2) for dx, dy in ga + gb)
    got = SK.sweep_wta_plain(C, partial, ndirs, P1, P2, 10, 1, direction=direction)
    for g, p, r in zip(got, plain, ref):
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), r)


def test_delta_groups_refuse_a_fused_direction_outside_the_paths():
    with pytest.raises(ValueError, match="fused direction"):
        SK.delta_groups(5, (0, -1))
    assert SK.delta_groups(8) == SK.delta_groups(8, SK.FUSED_DIR)


def test_probe_tool_pair_and_refusal_without_a_card(monkeypatch, capsys):
    """tools/probe_sweep: its pair has the known shift, it times every
    candidate fused direction, and without a CUDA device main() exits 2."""
    from stereo_reconstruction_cv_tpu_torch.tools import probe_sweep as tool

    left, right = tool.textured_pair(np.random.default_rng(1), 9, 50, 7)
    np.testing.assert_array_equal(left[:, 7:], right[:, :-7])
    assert SK.FUSED_DIR in SK.FUSED_CANDIDATES
    assert all(d in SK.DIRS_5 and d in SK.DIRS_8 for d in SK.FUSED_CANDIDATES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main() == 2
    assert "CUDA" in capsys.readouterr().out


def test_aggregate_probe_refuses_without_a_card(monkeypatch, capsys):
    from stereo_reconstruction_cv_tpu_torch.tools import probe_aggregate as tool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main() == 2
    assert "CUDA" in capsys.readouterr().out
