"""Port vs JAX reference: semi-global aggregation and winner-take-all.

The plain versions run here; the reference runs both as its XLA path (exact
scans, chunk=None) and as the TPU kernel chain sgm_wta_pallas in interpret
mode. Integer outputs are bit-exact and the f32 disparity is equal (same f32
operations in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu.ops import disparity as RD
from stereo_reconstruction_cv_tpu.ops.pallas.sgm_pallas import sgm_wta_pallas
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


def test_bounds_and_cpu_dispatch():
    with pytest.raises(ValueError, match="65535"):
        SK.check_sgm_bounds(P1, 16384, 128, 5)
    with pytest.raises(ValueError):
        SK.check_sgm_bounds(P1, P2, 128, 6)
    C = torch.from_numpy(_volume(30, (6, 9, 16)))
    before = dict(SK.launches)
    SK.sgm_wta(C, P1, P2, 8, 10, 0)
    assert SK.launches == before
