"""The benchmark's plain reference against the JAX package and the port's
CPU path, at a small size on the CPU: every map bit-equal."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark import scene  # noqa: E402
from benchmark.reference import rig as RR  # noqa: E402
from benchmark.reference import sgbm as RS  # noqa: E402
from stereo_reconstruction_cv_tpu.config import SGBMConfig as JaxConfig  # noqa: E402
from stereo_reconstruction_cv_tpu.ops import disparity as JD  # noqa: E402
from stereo_reconstruction_cv_tpu_torch import native  # noqa: E402
from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig  # noqa: E402
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP  # noqa: E402
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G  # noqa: E402
from stereo_reconstruction_cv_tpu_torch.ops import rectify as RC  # noqa: E402

CONFIG = {"width": 192, "height": 56,
          "rig": {"K": [[2253.71, 0.0, 1929.69], [0.0, 2244.72, 1057.63], [0.0, 0.0, 1.0]],
                  "K_width": 3840, "baseline_m": 0.14, "raw_axis": [0.3, 1.0, 0.2],
                  "raw_deg": 1.2, "raw_T": [-0.14, 0.004, -0.003], "alpha": 0.0}}


def params(paths: int) -> dict:
    return {"min_disparity": 0, "num_disparities": 16, "block_size": 11, "p1": 2904,
            "p2": 11616, "disp12_max_diff": 1, "pre_filter_cap": 63, "uniqueness_ratio": 10,
            "speckle_window_size": 100, "speckle_range": 32, "num_directions": paths,
            "speckle_backend": "propagate"}


@pytest.fixture(scope="module")
def pair():
    K, R, T = scene.rig(CONFIG, "rectified")
    return scene.render_pair(K, R, T, CONFIG["height"], CONFIG["width"], 7, "cpu")


@pytest.mark.parametrize("paths", [5, 8])
def test_reference_equals_jax_package(pair, paths):
    p = params(paths)
    disp, valid = RS.sgbm(*pair, p)
    jd, jv = JD.sgbm_disparity(jnp.asarray(pair[0].numpy()), jnp.asarray(pair[1].numpy()),
                               JaxConfig(**p))
    assert valid.any()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jd))


@pytest.mark.parametrize("paths", [5, 8])
def test_reference_equals_port_cpu_path(pair, paths):
    p = params(paths)
    disp, valid = RS.sgbm(*pair, p)
    pd, pv = DP.sgbm_disparity(*pair, SGBMConfig(**p))
    assert torch.equal(valid, pv)
    assert torch.equal(disp, pd)


def test_reference_rig_equals_port():
    K, R, T = scene.rig(CONFIG, "raw")
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    size = (CONFIG["width"], CONFIG["height"])
    ours = RR.stereo_rectify(f64(K), f64(K), size, f64(R), f64(T), alpha=0.0)
    port = RC.stereo_rectify(f64(K), None, f64(K), None, size, f64(R), f64(T), alpha=0.0)
    for a, b in zip(ours, port):
        assert torch.equal(a, b)
    left, _ = scene.render_pair(K, R, T, CONFIG["height"], CONFIG["width"], 3, "cpu")
    m_ours = RR.rectify_map(f64(K), ours.R1, ours.P1, size, "cpu")
    m_port = RC.rectify_map(f64(K), None, port.R1, port.P1, size, device="cpu")
    assert torch.equal(m_ours, m_port)
    assert torch.equal(RR.remap_bilinear(left, m_ours), RC.remap_bilinear(left, m_port))
    gen = torch.Generator().manual_seed(0)
    disp = torch.rand(CONFIG["height"], CONFIG["width"], generator=gen) * 20 - 2
    assert torch.equal(RR.reproject(disp, ours.Q), G.reproject_image_to_3d(disp, port.Q))


def test_speckle_reaches_the_exact_components():
    """A serpentine component that a 64-round flood does not finish: the
    reference's fixpoint equals the port's host union-find."""
    H, W, turns = 170, 40, 80
    valid = np.zeros((H, W), bool)
    for k in range(turns + 1):
        y = 2 * k
        valid[y, 2:W - 2] = True
        if k < turns:
            x = (W - 3, 2)[k % 2]
            valid[y + 1, x] = True
    rng = np.random.default_rng(0)
    disp = np.where(valid, 30.0 + rng.uniform(-1, 1, (H, W)), 0.0).astype(np.float32)
    valid[61, 10:14] = True  # a small blob of its own between two turns
    disp[61, 10:14] = 5.0
    keep = RS.speckle_keep(torch.from_numpy(disp), torch.from_numpy(valid), 100, 2.0)
    exact = native.filter_speckles(disp, valid, 100, 2.0)
    with pytest.raises(RuntimeError):  # a 64-round flood stops short of the fixpoint
        RS.speckle_keep(torch.from_numpy(disp), torch.from_numpy(valid), 100, 2.0, max_rounds=64)
    assert keep.numpy()[0].any() and not keep.numpy()[61, 11]
    np.testing.assert_array_equal(keep.numpy(), exact)
