"""Port vs JAX reference: left-right consistency (disp12MaxDiff).

The plain version runs here against the reference's XLA ``lr_check_maps`` /
``lr_check`` and against the TPU kernel ``lr_check_maps_pallas`` in interpret
mode. Keep masks are bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu.ops import disparity as RD
from stereo_reconstruction_cv_tpu.ops.pallas.lr_pallas import lr_check_maps_pallas
from stereo_reconstruction_cv_tpu_torch.ops.cuda import lr as LK


def _maps(seed, H=18, Wc=70, D=24, min_disp=0, cost_range=4):
    """Winner maps with many tied winning costs and subpixel offsets."""
    rng = np.random.default_rng(seed)
    best = rng.integers(0, D, (H, Wc)).astype(np.int32)
    minS = rng.integers(0, cost_range, (H, Wc)).astype(np.int32)
    frac = rng.uniform(-0.5, 0.5, (H, Wc)).astype(np.float32)
    frac[rng.random((H, Wc)) < 0.2] = 0.0  # integer disparities: floor == ceil
    disp = (best.astype(np.float32) + frac + np.float32(min_disp)).astype(np.float32)
    return best, minS, disp


@pytest.mark.parametrize("min_disp,max_diff", [(0, 1), (3, 1), (3, 0), (0, 2)])
def test_lr_check_maps_matches_reference(min_disp, max_diff):
    D = 24
    best, minS, disp = _maps(min_disp * 10 + max_diff, D=D, min_disp=min_disp)
    ref = RD.lr_check_maps(jnp.asarray(best), jnp.asarray(minS), jnp.asarray(disp),
                           D, min_disp, max_diff)
    got = LK.lr_check_maps(*map(torch.from_numpy, (best, minS, disp)), D, min_disp, max_diff)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.float().mean() < 1  # both outcomes occur


@pytest.mark.parametrize("min_disp", [0, 3])
def test_lr_check_maps_matches_pallas_interpret(min_disp):
    D = 16
    best, minS, disp = _maps(40 + min_disp, H=20, Wc=50, D=D, min_disp=min_disp)
    ref = lr_check_maps_pallas(jnp.asarray(best), jnp.asarray(minS), jnp.asarray(disp),
                               D, min_disp, 1, interpret=True)
    got = LK.lr_check_maps_plain(*map(torch.from_numpy, (best, minS, disp)), D, min_disp, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_lr_check_from_volume_matches_reference():
    S = np.random.default_rng(9).integers(0, 40, (14, 30, 16)).astype(np.int32)
    disp, _ = RD.wta_disparity(jnp.asarray(S), 2, 10)
    ref = RD.lr_check(jnp.asarray(S), disp, 2, 1)
    got = LK.lr_check(torch.from_numpy(S), torch.from_numpy(np.array(disp)), 2, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cpu_dispatch_and_validation():
    best, minS, disp = _maps(50)
    before = dict(LK.launches)
    LK.lr_check_maps(*map(torch.from_numpy, (best, minS, disp)), 24, 0, 1)
    assert LK.launches == before
    with pytest.raises(ValueError):
        LK.lr_check_maps(*map(torch.from_numpy, (best, minS, disp[:, :5])), 24, 0, 1)
