"""Port vs JAX reference: the dense slice, pair -> disparity -> points -> PLY.

The reference runs its XLA path (backend="xla"); the port runs its plain
versions (CPU tensors). Disparity and masks are exact, points rtol 1e-5.
Also: the port's own g++ speckle build, the rectification converter, the CLI,
and that importing the port pulls in no jax.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stereo_reconstruction_cv_tpu import native as ref_native
from stereo_reconstruction_cv_tpu.config import SGBMConfig
from stereo_reconstruction_cv_tpu.io import ply as PLY
from stereo_reconstruction_cv_tpu.ops import disparity as RD
from stereo_reconstruction_cv_tpu.ops import rectify as RR
from stereo_reconstruction_cv_tpu.pipeline import stages as RS
from stereo_reconstruction_cv_tpu_torch import cli, convert, native
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops import rectify as RC
from stereo_reconstruction_cv_tpu_torch.ops.cuda import cost as CK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import lr as LK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import speckle as SPK
from stereo_reconstruction_cv_tpu_torch.pipeline import stages

K_4K = np.array([[2253.71, 0.0, 1929.69], [0.0, 2244.72, 1057.63], [0.0, 0.0, 1.0]])
H, W, SHIFT = 48, 96, 7


def _pair(seed=0, h=H, w=W, shift=SHIFT):
    """left[y, x] == right[y, x - shift], plus a re-noised patch in the right
    view whose mismatched costs leave small speckle islands."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w + shift), dtype=np.uint8)
    left, right = base[:, :w].copy(), base[:, shift:].copy()
    right[8:40, 30:80] = rng.integers(0, 256, (32, 50), dtype=np.uint8)
    return left, right


def _rig(w=W, h=H):
    K = K_4K.copy()
    K[:2] *= w / 3840.0
    rr = RR.stereo_rectify(jnp.asarray(K), None, jnp.asarray(K), None, (w, h),
                           jnp.eye(3), jnp.asarray([-0.14, 0.0, 0.0]), alpha=0.0)
    return K, rr


@pytest.mark.parametrize("ndirs,min_disp,speckle,speckle_backend", [
    pytest.param(5, 0, 0, "exact", id="5-0-0"),
    pytest.param(8, 3, 0, "exact", id="8-3-0"),
    pytest.param(5, 0, 100, "exact", id="5-0-100"),
    pytest.param(5, 0, 100, "propagate", id="5-0-100-propagate"),
    pytest.param(8, 3, 100, "propagate", id="8-3-100-propagate"),
])
def test_sgbm_disparity_matches_reference(ndirs, min_disp, speckle, speckle_backend):
    left, right = _pair(1)
    # speckle_range 1: at 16 disparities the default 32 joins every valid pixel.
    cfg = SGBMConfig(num_disparities=16, min_disparity=min_disp, num_directions=ndirs,
                     speckle_window_size=speckle, speckle_range=1,
                     speckle_backend=speckle_backend, backend="xla")
    dr, vr = RD.sgbm_disparity(jnp.asarray(left), jnp.asarray(right), cfg)
    d, v = DP.sgbm_disparity(torch.from_numpy(left), torch.from_numpy(right), cfg)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dr))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    assert 0.5 < v.float().mean() < 1.0
    if speckle:  # the filter removed something the unfiltered map kept
        _, v0 = DP.sgbm_disparity(torch.from_numpy(left), torch.from_numpy(right),
                                  cfg.with_(speckle_window_size=0))
        assert (v0 & ~v).any()


def test_compute_disparity_map_matches_reference():
    left, right = _pair(1)
    ref = np.asarray(RD.compute_disparity_map(jnp.asarray(left), jnp.asarray(right), 16, 0))
    got = DP.compute_disparity_map(torch.from_numpy(left), torch.from_numpy(right), 16, 0)
    np.testing.assert_array_equal(got.numpy(), ref)
    # The device speckle backend: same map as the reference's, and (the flood
    # converges on this pair) as the exact host filter's.
    ref_p = np.asarray(RD.compute_disparity_map(jnp.asarray(left), jnp.asarray(right), 16, 0,
                                                speckle_backend="propagate"))
    got_p = DP.compute_disparity_map(torch.from_numpy(left), torch.from_numpy(right), 16, 0,
                                     speckle_backend="propagate")
    np.testing.assert_array_equal(got_p.numpy(), ref_p)
    np.testing.assert_array_equal(got_p.numpy(), ref)
    rgb = np.random.default_rng(2).integers(0, 256, (H, W, 3), dtype=np.uint8)
    np.testing.assert_array_equal(DP.rgb_to_gray_u8(torch.from_numpy(rgb)).numpy(),
                                  np.asarray(RD.rgb_to_gray_u8(jnp.asarray(rgb))))


def test_port_speckle_build_matches_reference_native():
    rng = np.random.default_rng(3)
    disp = np.repeat(rng.integers(0, 6, (30, 40)), 2, axis=1).astype(np.float32) * 8
    valid = rng.random(disp.shape) < 0.9
    for max_size, max_diff in ((4, 8.0), (20, 1.0), (100, 32.0)):
        ref = ref_native.filter_speckles(disp, valid, max_size, max_diff)
        got = native.filter_speckles(disp, valid, max_size, max_diff)
        np.testing.assert_array_equal(got, ref)


def test_slice_pair_to_ply_matches_reference(tmp_path):
    """Raw pair -> rectify -> disparity -> 3D -> PLY, in both packages."""
    left, right = _pair(4)
    K, rr = _rig()
    rect = convert.from_reference_rectification(rr)
    Kt = torch.from_numpy(K)
    ref_imgs = [np.asarray(RR.rectify_remap(jnp.asarray(im), jnp.asarray(K), None, R, P))
                for im, R, P in ((left, rr.R1, rr.P1), (right, rr.R2, rr.P2))]
    imgs = [RC.rectify_remap(torch.from_numpy(im), Kt, None, R, P)
            for im, R, P in ((left, rect.R1, rect.P1), (right, rect.R2, rect.P2))]
    for a, b in zip(imgs, ref_imgs):
        assert np.abs(a.numpy().astype(int) - b.astype(int)).max() <= 1
    # From here on both chains take the reference's rectified pair.
    d_ref = RS.disparity(*ref_imgs, ndisp=16)
    pts_ref = RS.reconstruct(d_ref, np.asarray(rr.Q))
    n_ref = RS.export_point_cloud(str(tmp_path / "ref.ply"), pts_ref, d_ref)
    d = stages.disparity(*ref_imgs, ndisp=16, device="cpu")
    pts = stages.reconstruct(d, rect.Q, device="cpu")
    n = stages.export_point_cloud(str(tmp_path / "port.ply"), pts, d, device="cpu")
    np.testing.assert_array_equal(d.numpy(), d_ref)
    assert n == n_ref > 0.5 * H * (W - 16)
    p_ref, _ = PLY.read_ply(str(tmp_path / "ref.ply"))
    p, _ = PLY.read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_allclose(p, p_ref, rtol=1e-5)
    # The port's own rectified pair recovers the same disparities.
    d_own = stages.disparity(*imgs, ndisp=16, device="cpu").numpy()
    both = (d_own > 0) & (d_ref > 0)
    assert (np.abs(d_own - d_ref)[both] <= 1).mean() > 0.99


def test_convert_round_trip(tmp_path):
    K, rr = _rig()
    rect = convert.from_reference_rectification(rr)
    for name in ("R1", "R2", "P1", "P2", "Q"):
        np.testing.assert_array_equal(getattr(rect, name).numpy(), np.asarray(getattr(rr, name)))
        assert getattr(rect, name).dtype == torch.float64
    own = RC.stereo_rectify(torch.from_numpy(K), None, torch.from_numpy(K), None, (W, H),
                            torch.eye(3, dtype=torch.float64),
                            torch.tensor([-0.14, 0.0, 0.0], dtype=torch.float64), alpha=0.0)
    np.testing.assert_allclose(own.Q.numpy(), rect.Q.numpy(), atol=1e-9)
    path = tmp_path / "rectification.npz"
    np.savez(path, **{k: getattr(rect, k).numpy() for k in ("R1", "R2", "P1", "P2", "Q")})
    back = convert.from_reference_rectification(str(path))
    for name in ("R1", "R2", "P1", "P2", "Q"):
        assert torch.equal(getattr(back, name), getattr(rect, name))
    np.savez(tmp_path / "q_only.npz", Q=np.asarray(rr.Q))
    q_only = convert.from_reference_rectification(str(tmp_path / "q_only.npz"))
    assert q_only.R1 is None and torch.equal(q_only.Q, rect.Q)
    with pytest.raises(KeyError):
        convert.from_reference_rectification({"R1": np.eye(3)})


def test_cli_reconstruct_on_cpu(tmp_path, capsys):
    left, right = _pair(5)
    pair = tmp_path / "pair"
    pair.mkdir()
    Image.fromarray(left).convert("RGB").save(pair / "img1.jpg", quality=95)
    Image.fromarray(right).convert("RGB").save(pair / "img2.jpg", quality=95)
    _, rr = _rig()
    npz = tmp_path / "rectification.npz"
    np.savez(npz, **{k: np.asarray(getattr(rr, k)) for k in ("R1", "R2", "P1", "P2", "Q")})
    out = tmp_path / "cloud.ply"
    argv = ["reconstruct", str(pair), "--rectification", str(npz), "--ndisp", "16",
            "--device", "cpu", "--output", str(out)]
    assert cli.main(argv) == 0
    pts, colors = PLY.read_ply(str(out))
    from stereo_reconstruction_cv_tpu.io.image import load_stereo_pair

    imL, imR = load_stereo_pair(str(pair))
    d = stages.disparity(imL, imR, ndisp=16, device="cpu")
    assert len(pts) == int((d > 0).sum()) > 0 and colors is not None
    assert cli.main(["reconstruct", str(pair), "--device", "cpu"]) == 2
    assert "--rectification" in capsys.readouterr().err
    assert cli.main(["disparity", str(pair), "--ndisp", "16", "--device", "cpu",
                     "--outdir", str(tmp_path / "d")]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "d" / "disparity.npy"), d.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            stages.disparity(imL, imR, device="cuda")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import stereo_reconstruction_cv_tpu_torch, stereo_reconstruction_cv_tpu_torch.cli\n"
        "import stereo_reconstruction_cv_tpu_torch.convert, stereo_reconstruction_cv_tpu_torch.native\n"
        "import stereo_reconstruction_cv_tpu_torch.ops.disparity, stereo_reconstruction_cv_tpu_torch.ops.rectify\n"
        "import stereo_reconstruction_cv_tpu_torch.pipeline.stages\n"
        "import stereo_reconstruction_cv_tpu_torch.ops.cuda.speckle\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_launch_counters_stay_zero_on_cpu():
    left, right = _pair(6)
    before = {**CK.launches, **SK.launches, **LK.launches, **SPK.launches}
    assert set(SPK.launches) == {"speckle_labels", "speckle_keep"}
    for backend in ("exact", "propagate"):
        DP.compute_disparity_map(torch.from_numpy(left), torch.from_numpy(right), 16, 0,
                                 speckle_backend=backend)
    SK.sgm_aggregate(torch.zeros((4, 5, 16), dtype=torch.int16), 8, 32)
    assert {**CK.launches, **SK.launches, **LK.launches, **SPK.launches} == before
    assert all(v == 0 for v in before.values())


def test_unported_options_raise():
    """The reference's default config (speckle_backend "propagate") runs and
    equals the reference bit for bit; chunked scans stay a TPU-only option."""
    left, right = _pair(7)
    cfg = SGBMConfig(num_disparities=16)
    assert cfg.speckle_backend == "propagate"
    dr, vr = RD.sgbm_disparity(jnp.asarray(left), jnp.asarray(right), cfg.with_(backend="xla"))
    left, right = torch.from_numpy(left), torch.from_numpy(right)
    d, v = DP.sgbm_disparity(left, right, cfg)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dr))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    assert v.any()
    with pytest.raises(ValueError, match="speckle_backend"):
        DP.sgbm_disparity(left, right, cfg.with_(speckle_backend="flood"))
    with pytest.raises(ValueError, match="scan_chunk"):
        DP.sgbm_disparity(left, right, SGBMConfig(num_disparities=16, scan_chunk=64))
