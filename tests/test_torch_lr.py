"""Port vs JAX reference: left-right consistency (disp12MaxDiff).

The plain version runs here against the reference's XLA ``lr_check_maps`` /
``lr_check`` and against the TPU kernel ``lr_check_maps_pallas`` in interpret
mode, on random maps and on the stress maps the card's tests hold the kernel
to (tests/test_torch_gpu.py). Keep masks are bit-exact.
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


def _stress(kind, seed=0):
    """The LR kernel's stress maps (tests/test_torch_gpu.py), at small size:
    (best, minS, disp, D, min_disp)."""
    rng = np.random.default_rng(seed)
    H, Wc, D, md = {"one column": (6, 24, 24, 0), "constant best": (5, 70, 16, 0),
                    "min_disp": (7, 50, 16, 7), "ragged": (5, 61, 13, 2),
                    "rows per block": (9, 10, 8, 3), "single row": (1, 7, 5, 1)}[kind]
    best = rng.integers(0, D, (H, Wc)).astype(np.int32)
    if kind == "one column":  # Wc == D: every left pixel aims at right column D
        best = np.broadcast_to(np.arange(Wc, dtype=np.int32), (H, Wc)).copy()
    elif kind == "constant best":
        best[:] = 11
    minS = rng.integers(0, 3, (H, Wc)).astype(np.int32)
    frac = rng.uniform(-0.5, 0.5, (H, Wc)).astype(np.float32)
    frac[rng.random((H, Wc)) < 0.2] = 0.0
    disp = (best + frac + md).astype(np.float32)
    return best, minS, disp, D, md


@pytest.mark.parametrize("kind", ["one column", "constant best", "min_disp", "ragged",
                                  "rows per block", "single row"])
def test_stress_maps_match_reference_and_pallas_interpret(kind):
    """The yardstick the card holds the kernel to: the plain version equals
    the reference's XLA check and its TPU kernel on the stress maps."""
    best, minS, disp, D, md = _stress(kind)
    args = tuple(map(jnp.asarray, (best, minS, disp)))
    got = LK.lr_check_maps_plain(*map(torch.from_numpy, (best, minS, disp)), D, md, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(RD.lr_check_maps(*args, D, md, 1)))
    np.testing.assert_array_equal(got, np.asarray(lr_check_maps_pallas(*args, D, md, 1,
                                                                       interpret=True)))


@pytest.mark.parametrize("max_diff", [0, 1])
def test_out_is_anded_in_place(max_diff):
    best, minS, disp = map(torch.from_numpy, _maps(60))
    start = torch.from_numpy(np.random.default_rng(1).random(best.shape) < 0.7)
    out = start.clone()
    assert LK.lr_check_maps(best, minS, disp, 24, 0, max_diff, out=out) is out
    assert torch.equal(out, start & LK.lr_check_maps(best, minS, disp, 24, 0, max_diff))


@pytest.mark.parametrize("out", [torch.ones((18, 69), dtype=torch.bool),
                                 torch.ones((18, 70), dtype=torch.uint8)])
def test_out_argument_checks(out):
    best, minS, disp = map(torch.from_numpy, _maps(61))
    with pytest.raises(ValueError, match="out must be"):
        LK.lr_check_maps(best, minS, disp, 24, 0, 1, out=out)


def test_rows_per_block_and_the_shared_memory_limit():
    assert LK.lr_rows_per_block(2160, 3584, 256, 0) == 1       # 4K x 256: 15 KB a row
    assert LK.lr_rows_per_block(720, 1152, 128, 0) == 1        # 720p x 128
    assert LK.lr_rows_per_block(71, 30, 16, 3) == 35           # short rows: ~1024 pixels
    assert LK.lr_rows_per_block(3, 30, 16, 3) == 3
    assert LK.lr_rows_per_block(2, 12400, 16, 0) == 1          # one row past 48 KB
    Wc = LK.SMEM_BLOCK_MAX // 4 - 16
    assert LK.lr_rows_per_block(2, Wc, 16, 0) == 1
    with pytest.raises(ValueError, match="shared memory"):
        LK.lr_rows_per_block(2, Wc + 1, 16, 0)
