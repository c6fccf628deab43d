"""The port's JPEG decode, prefetch loader and streaming path against the JAX reference, on the CPU.

``native.decode_jpeg`` with the "libjpeg" decoder builds the reference's own
``native/jpeg_loader.cc``, so its frames must equal the reference's
``native.decode_jpeg`` bit for bit; the loader must yield the reference
loader's batches; ``dense_batch_step`` and ``stream_reconstruct`` must give
the reference's maps and clouds on the same JPEG pairs (96x160, 16
disparities). The disparity maps and masks are integer work and compared
exactly; the points are float32 quotients of the same expressions, held to
F32_RTOL of the cloud's largest coordinate. The card's decoder ("nvjpeg")
and the pinned, side-stream copies are tested in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from stereo_reconstruction_cv_tpu import native as ref_native
from stereo_reconstruction_cv_tpu.config import SGBMConfig as RefSGBMConfig
from stereo_reconstruction_cv_tpu.io import ply as RPLY
from stereo_reconstruction_cv_tpu.parallel import prefetch as RPF
from stereo_reconstruction_cv_tpu.parallel import streaming as RST
from stereo_reconstruction_cv_tpu_torch import convert, native
from stereo_reconstruction_cv_tpu_torch.errors import DataError
from stereo_reconstruction_cv_tpu_torch.io import ply as PLY
from stereo_reconstruction_cv_tpu_torch.parallel import streaming as ST
from stereo_reconstruction_cv_tpu_torch.parallel.prefetch import PrefetchLoader
from stereo_reconstruction_cv_tpu_torch.utils import synth

# Relative error allowed between the port's and the reference's float32
# points (the same quotients, evaluated by two frameworks): a few ulps.
F32_RTOL = 4e-7
H, W, D = 96, 160, 16
K = np.array([[150.0, 0.0, 80.0], [0.0, 150.0, 48.0], [0.0, 0.0, 1.0]])
Q = np.array([[1.0, 0, 0, -80.0], [0, 1.0, 0, -48.0], [0, 0, 0, 150.0], [0, 0, 1 / 0.14, 0]])


def _save(path, img, quality=95):
    Image.fromarray(img).save(path, quality=quality)
    return str(path)


@pytest.fixture(scope="module")
def scene_pairs(tmp_path_factory):
    """Three rendered pairs of the rectified rig (seeds 0-2) as gray JPEG files."""
    root = tmp_path_factory.mktemp("pairs")
    pairs = []
    for k in range(3):
        left, right = synth.render_pair(K, np.eye(3), (-0.14, 0.0, 0.0), H, W, seed=k)
        pairs.append(tuple(_save(root / f"p{k}{s}.jpg", img.numpy())
                           for s, img in zip("lr", (left, right))))
    return pairs


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("gray", [True, False])
def test_decode_jpeg_is_bit_equal_to_the_reference(tmp_path, mode, gray):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    path = _save(tmp_path / "x.jpg", img[..., 0] if mode == "L" else img, quality=85)
    with open(path, "rb") as f:
        data = f.read()
    want = ref_native.decode_jpeg(data, gray)
    got = native.decode_jpeg(data, gray, "libjpeg")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.load_image(path, gray, "libjpeg"), want)
    out = np.zeros(want.shape, np.uint8)
    assert native.decode_jpeg(data, gray, "libjpeg", out=out) is out
    np.testing.assert_array_equal(out, want)
    assert native.jpeg_info(data, "libjpeg") == (37, 53, 1 if mode == "L" else 3)


def test_bad_jpeg_data_raises_data_error(tmp_path):
    """Where the reference returns None (and its loader falls back to PIL),
    the port raises DataError, naming the file when it read one."""
    assert ref_native.decode_jpeg(b"not a jpeg") is None
    for data in (b"not a jpeg", b""):
        with pytest.raises(DataError):
            native.decode_jpeg(data, True, "libjpeg")
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\x00" * 64)
    with pytest.raises(DataError, match="bad.jpg"):
        native.load_image(str(bad), True, "libjpeg")
    with pytest.raises(ValueError, match="decoder"):
        native.decode_jpeg(b"\xff\xd8", True, "pil")
    good = _save(tmp_path / "good.jpg", np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match="shape"):
        native.load_image(good, True, "libjpeg", out=np.zeros((8, 9), np.uint8))


def test_prefetch_loader_yields_all_batches_in_order(scene_pairs):
    """5 pairs at batch 2: 3 batches, in order, equal to each frame decoded
    alone and to the reference loader's batches (reference
    tests/test_native.py:51, on rendered files)."""
    pairs = [scene_pairs[k % 3] for k in range(5)]
    with PrefetchLoader(pairs, batch_size=2, prefetch=2, decoder="libjpeg", device="cpu") as loader:
        batches = list(loader)
        assert len(loader) == 3
    assert [tuple(b[0].shape) for b in batches] == [(2, H, W), (2, H, W), (1, H, W)]
    assert loader.images_decoded == 10 and loader.h2d_copies == 0
    for k, row in enumerate(pairs):
        for col, path in enumerate(row):
            np.testing.assert_array_equal(batches[k // 2][col][k % 2].numpy(),
                                          native.load_image(path, True, "libjpeg"))
    ref = list(RPF.PrefetchLoader(pairs, batch_size=2, prefetch=2))
    for got, want in zip(batches, ref):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_prefetch_loader_frame_sizes_and_rgb(tmp_path):
    """Columns of two sizes get one tensor each; RGB frames are (B, H, W, 3);
    a column whose frames differ in size raises DataError."""
    rng = np.random.default_rng(5)
    a = [_save(tmp_path / f"a{i}.jpg", rng.integers(0, 256, (24, 40, 3), dtype=np.uint8))
         for i in range(2)]
    b = [_save(tmp_path / f"b{i}.jpg", rng.integers(0, 256, (16, 32, 3), dtype=np.uint8))
         for i in range(2)]
    with PrefetchLoader(list(zip(a, b)), batch_size=2, gray=False, decoder="libjpeg",
                        device="cpu") as loader:
        (left, right), = list(loader)
    assert left.shape == (2, 24, 40, 3) and right.shape == (2, 16, 32, 3)
    np.testing.assert_array_equal(right[1].numpy(), native.load_image(b[1], False, "libjpeg"))
    with PrefetchLoader([(a[0],), (b[0],)], batch_size=2, decoder="libjpeg",
                        device="cpu") as loader:
        with pytest.raises(DataError, match="sizes"):
            list(loader)


def test_dense_batch_step_equals_the_reference(scene_pairs):
    frames = [[native.load_image(p, True, "libjpeg") for p in row] for row in scene_pairs[:2]]
    left, right = (np.stack([f[c] for f in frames]) for c in (0, 1))
    ref_cfg = RefSGBMConfig(num_disparities=D, num_directions=8)
    rd, rp, rv = (np.asarray(x) for x in RST.dense_batch_step(left, right, Q, ref_cfg))
    d, p, v = ST.dense_batch_step(torch.from_numpy(left), torch.from_numpy(right), Q,
                                  convert.sgbm_config(ref_cfg))
    np.testing.assert_array_equal(d.numpy(), rd)
    np.testing.assert_array_equal(v.numpy(), rv)
    assert v.any()
    keep = v.numpy() & (rd > 0)
    np.testing.assert_allclose(p.numpy()[keep], rp[keep], rtol=0, atol=F32_RTOL * np.abs(rp[keep]).max())


@pytest.mark.parametrize("directions", [5, 8])
def test_stream_reconstruct_clouds_equal_the_reference(scene_pairs, tmp_path, directions):
    """Three pairs at batch 2 (a full batch and a remainder): the same
    cloud_{idx:04d}.ply files, the same points in the same order."""
    ref_cfg = RefSGBMConfig(num_disparities=D, num_directions=directions)
    want = RST.stream_reconstruct(scene_pairs, Q, ref_cfg, str(tmp_path / "ref"), batch_size=2)
    got = ST.stream_reconstruct(scene_pairs, Q, convert.sgbm_config(ref_cfg), str(tmp_path / "port"),
                                batch_size=2, prefetch=2, decoder="libjpeg", device="cpu")
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] == [
        "cloud_0000.ply", "cloud_0001.ply", "cloud_0002.ply"]
    for g, w in zip(got, want):
        pg, _ = PLY.read_ply(g)
        pw, _ = RPLY.read_ply(w)
        assert pg.shape == pw.shape and len(pw) > 0.2 * H * (W - D)
        np.testing.assert_allclose(pg, pw, rtol=0, atol=F32_RTOL * np.abs(pw).max())


def test_cloud_points_compacts_in_row_major_order():
    g = torch.Generator().manual_seed(0)
    disp = torch.rand((7, 9), generator=g) * 4 - 1
    pts = torch.randn((7, 9, 3), generator=g)
    pts[2, 3, 1] = float("inf")
    valid = torch.rand((7, 9), generator=g) > 0.3
    points, count = ST.cloud_points(disp, pts, valid)
    mask = valid & torch.isfinite(pts).all(-1) & (disp > 0)
    assert int(count) == int(mask.sum())
    assert torch.equal(points[: int(count)], pts[mask])
