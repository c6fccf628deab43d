"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where torch sees no CUDA device. On a machine
with a card (and no JAX) run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Shapes are small and ragged on purpose (D not a multiple of 32, one-lane D,
min_disp > 0, a 5x5 block, single-column crops); chip_smoke.py checks the
full-size shapes of the main path.
"""

import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu_torch.ops.cuda import cost as CK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import lr as LK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK

pytestmark = pytest.mark.gpu

P1, P2 = 8 * 3 * 121, 32 * 3 * 121


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _planes(seed, H, W, dev, cap=63):
    rng = np.random.default_rng(seed)
    left = torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8)).to(dev)
    right = torch.roll(left, -3, 1)
    out = []
    for p in (CK.xsobel_clip(left, cap), CK.xsobel_clip(right, cap), left.int(), right.int()):
        p = p.clone()
        p[:, 0] = cap
        p[:, -1] = cap
        out.append(p)
    return out


@pytest.mark.parametrize("H,W,D,md,block", [
    (24, 60, 16, 0, 11), (33, 150, 100, 3, 11), (17, 41, 32, 8, 5), (9, 50, 48, 1, 11),
])
def test_cost_volume_kernel_equals_plain(dev, H, W, D, md, block):
    planes = _planes(H * W, H, W, dev)
    got = CK.cost_volume(*planes, D, md, block)
    ref = CK.cost_volume_plain(*planes, D, md, block)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("nd", [5, 8])
@pytest.mark.parametrize("H,W,D,md", [(19, 37, 16, 0), (26, 45, 100, 3), (8, 70, 256, 2)])
def test_sgm_kernels_equal_plain(dev, nd, H, W, D, md):
    rng = np.random.default_rng(D + nd)
    C = torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    vols = SK.path_deltas_cuda(C, nd, P1, P2)
    plain = [sum(SK.path_delta_plain(C, dx, dy, P1, P2) for dx, dy in g)
             for g in SK.delta_groups(nd) if g]
    assert len(vols) == len(plain)
    for v, p in zip(vols, plain):
        assert torch.equal(SK.u16(v), p)
    got = SK.sgm_wta(C, P1, P2, nd, 10, md)
    ref = SK.sgm_wta_plain(C, P1, P2, nd, 10, md)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    keep = LK.lr_check_maps(got[2], got[3], got[0], D, md, 1)
    assert torch.equal(keep, LK.lr_check_maps_plain(got[2], got[3], got[0], D, md, 1))


def test_lr_kernel_ties_and_margins(dev):
    """Many equal winning costs: the atomic scatter must keep the smallest d."""
    rng = np.random.default_rng(5)
    H, Wc, D, md = 12, 90, 24, 4
    best = torch.from_numpy(rng.integers(0, D, (H, Wc), dtype=np.int32)).to(dev)
    minS = torch.from_numpy(rng.integers(0, 3, (H, Wc), dtype=np.int32)).to(dev)
    disp = best.float() + md + torch.from_numpy(rng.uniform(-0.5, 0.5, (H, Wc)).astype(np.float32)).to(dev)
    for max_diff in (0, 1, 3):
        got = LK.lr_check_maps(best, minS, disp, D, md, max_diff)
        assert torch.equal(got, LK.lr_check_maps_plain(best, minS, disp, D, md, max_diff))
