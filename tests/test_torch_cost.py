"""Port vs JAX reference: prefilter, BT cost volume, box sum, fused wrapper.

Same numpy inputs from a seed through both packages; every comparison is
bit-exact (integer stages). The wrapper runs its plain version here (CPU
tensors); the CUDA kernel is held to that plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu.ops import disparity as RD
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops.cuda import cost as CK


def _pair(seed, H, W):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H, W + 12), dtype=np.uint8)
    return base[:, :W].copy(), base[:, 12:].copy()


def _pinned_planes(left, right, cap=63):
    """The four border-pinned planes sgbm_disparity feeds the cost stage."""
    sl, sr = RD.xsobel_clip(jnp.asarray(left), cap), RD.xsobel_clip(jnp.asarray(right), cap)
    out = []
    for p in (sl, sr, jnp.asarray(left, jnp.int32), jnp.asarray(right, jnp.int32)):
        out.append(np.array(p.at[:, 0].set(cap).at[:, -1].set(cap)))
    return out


@pytest.mark.parametrize("cap", [63, 20])
def test_xsobel_clip_matches_reference(cap):
    left, _ = _pair(1, 31, 57)
    ref = np.asarray(RD.xsobel_clip(jnp.asarray(left), cap))
    got = CK.xsobel_clip(torch.from_numpy(left), cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("D,min_disp", [(16, 0), (24, 3)])
def test_bt_cost_volume_matches_reference(D, min_disp):
    planes = _pinned_planes(*_pair(2, 29, 64))
    ref = np.asarray(RD.bt_cost_volume(*map(jnp.asarray, planes), D, min_disp))
    got = CK.bt_cost_volume(*map(torch.from_numpy, planes), D, min_disp)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("block", [11, 5, 4])
def test_block_sum_matches_reference(block):
    vol = np.random.default_rng(3).integers(0, 190, (26, 45, 7)).astype(np.int16)
    ref = np.asarray(RD.block_sum(jnp.asarray(vol), block))
    got = CK.block_sum(torch.from_numpy(vol), block)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("D,min_disp", [(16, 0), (32, 3)])
def test_cost_volume_wrapper_matches_reference_pair(D, min_disp):
    """cost_volume on CPU == block_sum(bt_cost_volume(...)[:, x0:], 11) in JAX."""
    planes = _pinned_planes(*_pair(4, 40, 100))
    x0 = min_disp + D
    ref = RD.block_sum(RD.bt_cost_volume(*map(jnp.asarray, planes), D, min_disp)[:, x0:, :], 11)
    got = CK.cost_volume(*map(torch.from_numpy, planes), D, min_disp, 11)
    assert got.shape == (40, 100 - x0, D) and got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cost_bounds():
    CK.check_cost_bounds(11, 103)  # 121 * 269 = 32549 fits int16
    with pytest.raises(ValueError, match="overflow"):
        CK.check_cost_bounds(11, 104)  # 121 * 271 = 32791
    with pytest.raises(ValueError):
        CK.cost_volume(*[torch.zeros(8, 20, dtype=torch.int32)] * 4, 16, 4)  # W <= x0


def test_cpu_wrapper_launches_no_kernel():
    planes = [torch.from_numpy(p) for p in _pinned_planes(*_pair(5, 12, 40))]
    before, paths = dict(CK.launches), dict(CK.cost_paths)
    CK.cost_volume(*planes, 16, 0)
    CK.cost_volume(*[p.to(torch.uint8) for p in planes], 16, 0)
    assert CK.launches == before and CK.cost_paths == paths


@pytest.mark.parametrize("cap,dtype,H,W", [
    (63, torch.uint8, 23, 50), (127, torch.uint8, 23, 50),
    (128, torch.int32, 23, 50), (200, torch.int32, 23, 50),
    # sizes where the byte planes' interior columns or replicated rows run out
    (63, torch.uint8, 1, 1), (63, torch.uint8, 1, 2), (63, torch.uint8, 2, 3),
    (63, torch.uint8, 3, 2), (63, torch.uint8, 4, 7), (63, torch.uint8, 9, 1)])
def test_cost_planes_are_bytes_where_they_fit(cap, dtype, H, W):
    """cost_planes == the reference's pinned xsobel_clip and raw planes, as
    uint8 while 2 * cap <= 255 (the packed kernel's planes), else int32."""
    left, right = _pair(7, H, W)
    got = DP.cost_planes(torch.from_numpy(left), torch.from_numpy(right), cap)
    for g, ref in zip(got, _pinned_planes(left, right, cap)):
        assert g.dtype == dtype and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy().astype(np.int32), ref)


def test_cost_planes_of_wider_views_stay_int32():
    left, right = _pair(8, 9, 30)
    got = DP.cost_planes(torch.from_numpy(left).int(), torch.from_numpy(right).int(), 63)
    assert all(p.dtype == torch.int32 for p in got)
    for g, ref in zip(got, _pinned_planes(left, right)):
        np.testing.assert_array_equal(g.numpy(), ref)


@pytest.mark.parametrize("block,D,min_disp", [(11, 16, 0), (5, 24, 3), (14, 16, 1)])
def test_cost_volume_plain_of_byte_planes_equals_int32(block, D, min_disp):
    """The plain version on the uint8 planes == on the same planes as int32
    (the packed and the int32 kernel are each held to it on the card)."""
    planes = [torch.from_numpy(p) for p in _pinned_planes(*_pair(9, 30, 80))]
    wide = CK.cost_volume_plain(*planes, D, min_disp, block)
    narrow = CK.cost_volume_plain(*[p.to(torch.uint8) for p in planes], D, min_disp, block)
    assert narrow.dtype == torch.int16 and torch.equal(narrow, wide)


def test_u8x2_fits_while_lanes_hold_every_box_sum():
    """block^2 * (255 + 63) within 16 bits: block 14 (62,328), not 15 (71,550)."""
    assert [CK.u8x2_fits(b) for b in (1, 11, 14, 15, 22)] == [True, True, True, False, False]


@pytest.mark.parametrize("block", [1, 3, 4, 5, 11, 14])
@pytest.mark.parametrize("D", [1, 17, 96, 256])
def test_packed_cost_tile_fits_and_covers(block, D):
    groups, cols, rows = CK.cost_tile(block, D, 720, packed=True)
    assert rows == 64 and CK.cost_tile(block, D, 2160, packed=True) == (groups, cols, 256)
    assert 1 <= groups <= 4 and 8 * (groups - 1) < max(D, 8)
    assert cols % 32 == 0 and cols - block + 1 >= 32
    assert CK.cost_smem_bytes(block, groups, cols, packed=True) <= 100 * 1024
    # csrc/cost_volume.cu srcv_cost_volume_u8x2: one vertical item and one
    # staged item a thread (256 vertical threads of 320)
    assert cols * groups <= 256 and 2 * cols + 8 * groups - 1 <= 320


def test_packed_cost_smem_bytes_counts_each_buffer():
    # 11 x 64 columns x 4 groups: staged words 2 x 24 x (64 + 95), vertical
    # sums 2 x 4 x 66 and the ring 11 x 256 entries of 16 bytes
    assert CK.cost_smem_bytes(11, 4, 64, packed=True) == 48 * 159 + 16 * (528 + 2816)


@pytest.mark.slow
@pytest.mark.parametrize("D,min_disp", [(32, 0), (32, 16)])
def test_cost_volume_matches_pallas_interpret(D, min_disp):
    """The TPU kernel itself (interpret mode, ~40 s a case) == the port."""
    from stereo_reconstruction_cv_tpu.ops.pallas.cost_pallas import cost_volume_pallas

    planes = _pinned_planes(*_pair(6, 24, 300))
    ref = cost_volume_pallas(*map(jnp.asarray, planes), D, min_disp, interpret=True)
    got = CK.cost_volume(*map(torch.from_numpy, planes), D, min_disp, 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("block", [1, 3, 4, 5, 11, 21, 22, 33, 64, 103])
@pytest.mark.parametrize("D", [1, 17, 96, 256])
def test_cost_tile_fits_and_covers(block, D):
    """Every tile leaves output columns, fits a block's shared memory, and
    keeps its blocks small enough to share an SM wherever the ring allows."""
    groups, cols, rows = CK.cost_tile(block, D, 720)
    assert rows == 64 and CK.cost_tile(block, D, 2160) == (groups, cols, 128)
    assert 1 <= groups <= 4 and 8 * (groups - 1) < max(D, 8)
    assert cols >= block + 7
    smem = CK.cost_smem_bytes(block, groups, cols)
    assert smem <= 232448
    if block <= 22:
        assert cols % 32 == 0 and cols - block + 1 >= 32 and smem <= 100 * 1024


def test_cost_smem_bytes_counts_each_buffer():
    # 11 x 64 columns x 4 groups: triples 2 x 2 x (64 + 95), vertical sums
    # 2 x 4 x 65, ring 11 x 256
    assert CK.cost_smem_bytes(11, 4, 64) == 16 * (636 + 520 + 2816)
    with pytest.raises(ValueError, match="shared memory"):
        CK.cost_tile(200, 128, 720)


@pytest.mark.parametrize("D,ptr,vec", [(128, 0, True), (128, 8, False), (96, 16, True),
                                       (100, 0, False), (17, 0, False), (1, 0, False)])
def test_cost_vector_store_choice(D, ptr, vec):
    assert CK.cost_vector_store(D, ptr) is vec
