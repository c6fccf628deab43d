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
    before = dict(CK.launches)
    CK.cost_volume(*planes, 16, 0)
    assert CK.launches == before


@pytest.mark.slow
@pytest.mark.parametrize("D,min_disp", [(32, 0), (32, 16)])
def test_cost_volume_matches_pallas_interpret(D, min_disp):
    """The TPU kernel itself (interpret mode, ~40 s a case) == the port."""
    from stereo_reconstruction_cv_tpu.ops.pallas.cost_pallas import cost_volume_pallas

    planes = _pinned_planes(*_pair(6, 24, 300))
    ref = cost_volume_pallas(*map(jnp.asarray, planes), D, min_disp, interpret=True)
    got = CK.cost_volume(*map(torch.from_numpy, planes), D, min_disp, 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
