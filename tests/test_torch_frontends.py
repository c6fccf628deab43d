"""The port's front-ends: the calibration stages and verbs, the stage cache,
the stage metrics, the HTML viewer and the report.

Calibration folders hold JPEGs of chip_smoke.py's calibration set rendered
at 960x540 (4 board poses seen by both cameras of its rig, 2x2 samples a
pixel), on the CPU with torch on one thread. The viewer's bytes are held to
the reference's write_html_viewer for the same points; the cache's file
names to the reference's StageCache for the same key; the metrics'
summary to the reference's Metrics; the error dicts to the reference's
stages where those return before any JAX work.
"""

import json
import os
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from stereo_reconstruction_cv_tpu.io import viewer as RVW
from stereo_reconstruction_cv_tpu.pipeline import cache as RCACHE
from stereo_reconstruction_cv_tpu.pipeline import stages as RS
from stereo_reconstruction_cv_tpu.utils import profiling as RPROF
from stereo_reconstruction_cv_tpu_torch import cli
from stereo_reconstruction_cv_tpu_torch.calib import chessboard as CB
from stereo_reconstruction_cv_tpu_torch.calib import zhang as Z
from stereo_reconstruction_cv_tpu_torch.io import image as IO
from stereo_reconstruction_cv_tpu_torch.io import ply as PLY
from stereo_reconstruction_cv_tpu_torch.io import viewer as VW
from stereo_reconstruction_cv_tpu_torch.pipeline import cache as CACHE
from stereo_reconstruction_cv_tpu_torch.pipeline import stages
from stereo_reconstruction_cv_tpu_torch.utils import capture, profiling, synth

ROOT = pathlib.Path(__file__).resolve().parent.parent
CALIB_KEYS = {"K", "dist", "rvecs", "tvecs", "rms", "mean_error", "per_view_error", "num_images",
              "results"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def boards(tmp_path_factory):
    """Two folders cam1/, cam2/ of the calibration set's views as JPEGs, a
    folder with two of them, an empty one, and the set's truth."""
    cs = synth.calibration_set("cpu", H=540, W=960, n=4, ss=2)
    root = tmp_path_factory.mktemp("boards")
    for cam, name in enumerate(("cam1", "cam2")):
        (root / name).mkdir()
        for i, img in enumerate(cs["views"][cam]):
            Image.fromarray(img.numpy()).save(root / name / f"view{i:02d}.jpg", quality=95)
    (root / "two").mkdir()
    for i in range(2):
        Image.fromarray(cs["views"][0][i].numpy()).save(root / "two" / f"view{i}.jpg", quality=95)
    (root / "empty").mkdir()
    return root, cs


@pytest.fixture(scope="module")
def calibrated(boards):
    root, _ = boards
    return stages.calibrate(str(root / "cam1"), device="cpu")


def test_calibrate_stage_on_rendered_jpegs(boards, calibrated):
    """The reference's keys and result tuple; the values the library gives
    on the same decoded images; K near the truth."""
    root, cs = boards
    out = calibrated
    assert set(out) == CALIB_KEYS and out["num_images"] == 4
    names = [n for n, _ in out["results"]]
    assert names == ["Camera Matrix", "Distortion Parameters", "Reprojection Error"]
    assert out["results"][2][1] == out["mean_error"] and isinstance(out["rms"], float)
    files = IO.glob_calibration_images(str(root / "cam1"))
    assert [os.path.basename(f) for f in files] == [f"view{i:02d}.jpg" for i in range(4)]
    corners = [CB.find_chessboard_corners(torch.from_numpy(IO.load_gray(f)))[1] for f in files]
    res = Z.calibrate_camera(Z.build_object_points(), torch.stack(corners), (960, 540))
    np.testing.assert_array_equal(out["K"], res.K.numpy())
    np.testing.assert_array_equal(out["dist"], res.dist.numpy())
    np.testing.assert_array_equal(out["per_view_error"], res.per_view_error.numpy())
    assert out["mean_error"] == float(res.mean_error) < 0.2
    np.testing.assert_allclose(out["K"], cs["K"], rtol=0.02, atol=1.0)


def test_calibrate_stage_cache_hit_returns_the_miss(boards, calibrated, tmp_path):
    """The miss writes <root>/calibrate-<hash>.npz under the reference's name
    for the same key; the hit returns the same values and types."""
    root, _ = boards
    folder = str(root / "cam1")
    cache = CACHE.StageCache(str(tmp_path / "c"))
    miss = stages.calibrate(folder, cache=cache, device="cpu")
    key = {"files": [CACHE.file_fingerprint(f) for f in IO.glob_calibration_images(folder)]}
    path = cache._path("calibrate", key)
    assert os.path.exists(path) and path == RCACHE.StageCache(str(tmp_path / "c"))._path("calibrate", key)
    assert sorted(os.listdir(tmp_path / "c")) == [os.path.basename(path)]
    hit = stages.calibrate(folder, cache=cache, device="cpu")
    assert set(hit) == set(miss) == CALIB_KEYS
    for k in ("K", "dist", "rvecs", "tvecs", "per_view_error"):
        np.testing.assert_array_equal(hit[k], miss[k])
        np.testing.assert_array_equal(hit[k], calibrated[k])
    for k in ("rms", "mean_error", "num_images"):
        assert hit[k] == miss[k] and type(hit[k]) is type(miss[k])
    assert [n for n, _ in hit["results"]] == [n for n, _ in miss["results"]]


def test_calibrate_stage_writes_corner_annotations(boards, tmp_path):
    root, _ = boards
    out = stages.calibrate(str(root / "cam1"), save_corner_annotations=True,
                           annotation_dir=str(tmp_path / "ann"), device="cpu")
    assert out["num_images"] == 4
    assert sorted(os.listdir(tmp_path / "ann")) == [f"view{i:02d}.jpg" for i in range(4)]
    assert IO.load_rgb(str(tmp_path / "ann" / "view00.jpg")).shape == (540, 960, 3)


def test_calibrate_stereo_rig_stage(boards):
    root, cs = boards
    out = stages.calibrate_stereo_rig(str(root / "cam1"), str(root / "cam2"), device="cpu")
    assert set(out) == {"K1", "dist1", "K2", "dist2", "R", "T", "rms", "num_pairs"}
    assert out["num_pairs"] == 4 and out["rms"] < 0.5
    r_err, t_err = synth.pose_errors(out["R"], out["T"], cs["R"], cs["T"])
    assert r_err < 0.2 and t_err < 3.0
    np.testing.assert_allclose(out["K2"], cs["K"], rtol=0.02, atol=1.0)


def test_calibration_error_dicts(boards):
    root, _ = boards
    empty, two = str(root / "empty"), str(root / "two")
    assert stages.calibrate(empty, device="cpu") == RS.calibrate(empty)
    assert stages.calibrate(empty, device="cpu")["error_kind"] == "data"
    assert stages.calibrate(two, device="cpu") == {
        "error": "chessboard found in only 2 images", "error_kind": "calibration"}
    cam1 = str(root / "cam1")
    assert (stages.calibrate_stereo_rig(cam1, two, device="cpu")
            == RS.calibrate_stereo_rig(cam1, two)
            == {"error": "need matching image counts (4 vs 2)", "error_kind": "data"})
    assert stages.calibrate_stereo_rig(empty, empty, device="cpu")["error_kind"] == "data"


def test_cli_calibrate_save_and_metrics(boards, tmp_path, capsys):
    root, _ = boards
    out, metrics = tmp_path / "calib.npz", tmp_path / "m.json"
    profiling.METRICS.reset()
    assert cli.main(["--metrics", str(metrics), "calibrate", str(root / "cam1"), "--save", str(out),
                     "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    for line in ("== Camera Matrix ==", "== Distortion Parameters ==", "== Reprojection Error ==",
                 "images used: 4", f"saved calibration to {out}", f"metrics -> {metrics}"):
        assert line in text
    with np.load(out) as z:
        assert sorted(z.files) == ["K", "dist", "rvecs", "tvecs"]
        assert z["K"].shape == (3, 3) and z["rvecs"].shape == (4, 3)
    m = json.loads(metrics.read_text())
    assert m["time/calibrate_s"] > 0 and m["time/calibrate_calls"] == 1
    assert m["calibrate/num_images"] == 4 and m["calibrate/mean_error"] < 0.2
    assert cli.main(["calibrate", str(root / "empty"), "--device", "cpu"]) == 1
    assert "no *.jpg calibration images" in capsys.readouterr().err


def test_cli_stereo_calibrate_save(boards, tmp_path, capsys):
    root, cs = boards
    out = tmp_path / "rig.npz"
    assert cli.main(["stereo-calibrate", str(root / "cam1"), str(root / "cam2"), "--save", str(out),
                     "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "== R ==" in text and "pairs used: 4" in text
    with np.load(out) as z:
        assert sorted(z.files) == sorted(["K1", "dist1", "K2", "dist2", "R", "T"])
        assert np.degrees(np.arccos(z["T"] @ cs["T"] / np.linalg.norm(z["T"]) / np.linalg.norm(cs["T"]))) < 3
    assert cli.main(["stereo-calibrate", str(root / "cam1"), str(root / "two"),
                     "--device", "cpu"]) == 1


@pytest.mark.parametrize("colors", ["none", "uint8", "float"])
@pytest.mark.parametrize("max_points", [2_000_000, 40])
def test_viewer_bytes_equal_the_reference(tmp_path, colors, max_points):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(97, 3)).astype(np.float32)
    c = {"none": None, "uint8": rng.integers(0, 256, (97, 3), dtype=np.uint8),
         "float": rng.uniform(-20, 300, (97, 3))}[colors]
    a, b = tmp_path / "ref.html", tmp_path / "port.html"
    n = VW.write_html_viewer(str(b), pts, c, max_points=max_points)
    assert n == RVW.write_html_viewer(str(a), pts, c, max_points=max_points) == min(97, max_points)
    assert a.read_bytes() == b.read_bytes()
    p, col = VW.read_html_viewer(str(b))
    assert p.shape == (n, 3) and (col is None) == (c is None)


def test_cli_view_and_html_export_equal_the_reference(tmp_path, capsys):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (50, 3), dtype=np.uint8)
    PLY.write_ply(str(tmp_path / "c.ply"), pts, colors)
    out = tmp_path / "v.html"
    assert cli.main(["view", str(tmp_path / "c.ply"), str(out), "--max-points", "30"]) == 0
    assert f"viewer with 30 points -> {out}" in capsys.readouterr().out
    RVW.write_html_viewer(str(tmp_path / "ref.html"), pts, colors, max_points=30)
    assert out.read_bytes() == (tmp_path / "ref.html").read_bytes()
    # export_point_cloud to .html: the valid points (finite, disparity > 0)
    img = rng.normal(size=(6, 8, 3)).astype(np.float32)
    img[0, 0] = np.inf
    disp = rng.uniform(-1, 3, (6, 8)).astype(np.float32)
    rgb = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
    n = stages.export_point_cloud(str(tmp_path / "e.html"), img, disp, rgb, device="cpu")
    keep = np.isfinite(img).all(-1) & (disp > 0)
    assert n == RVW.write_html_viewer(str(tmp_path / "e_ref.html"), img[keep], rgb[keep]) == keep.sum()
    assert (tmp_path / "e.html").read_bytes() == (tmp_path / "e_ref.html").read_bytes()


def test_metrics_summary_and_stage_timer_match_the_reference():
    ours, ref = profiling.Metrics(), RPROF.Metrics()
    for m in (ours, ref):
        m.record("detect/num", 12)
        m.add_timing("detect", 0.5)
        m.add_timing("detect", 1.5)
    assert ours.summary() == ref.summary() and ours.dump() == ref.dump()
    with profiling.stage_timer("x", ours, device="cpu"):
        pass
    assert ours.summary()["time/x_calls"] == 1
    ours.reset()
    assert ours.summary() == {}


def test_observed_stages_record_their_scalars():
    profiling.METRICS.reset()
    d = stages.disparity(np.zeros((8, 40), np.uint8), np.zeros((8, 40), np.uint8), 16, device="cpu")
    assert d.shape == (8, 40)
    s = profiling.METRICS.summary()
    assert s["time/disparity_calls"] == 1 and s["time/disparity_s"] > 0
    profiling.METRICS.reset()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("block"):
            torch.ones(64).sum()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "srcv.block" for e in events)


def test_capture_stdout():
    with capture.capture_stdout(echo=False) as buf:
        print("stage log")
    assert buf.getvalue() == "stage log\n"


def test_disparity_cache_hit_returns_the_miss(tmp_path):
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (24, 72), dtype=np.uint8)
    left, right = base[:, 6:].copy(), base[:, :-6].copy()
    cache = CACHE.StageCache(str(tmp_path))
    miss = stages.disparity(left, right, 16, cache=cache, device="cpu")
    assert len(os.listdir(tmp_path)) == 1 and os.listdir(tmp_path)[0].startswith("disparity-")
    key = stages._pair_cache_key((left, right), ndisp=16, mindis=0)
    assert cache._path("disparity", key) == RCACHE.StageCache(str(tmp_path))._path(
        "disparity", RS._pair_cache_key((left, right), ndisp=16, mindis=0))
    hit = stages.disparity(torch.from_numpy(left), torch.from_numpy(right), 16, cache=cache,
                           device="cpu")
    assert isinstance(hit, torch.Tensor)
    torch.testing.assert_close(hit, miss, rtol=0, atol=0)


def test_cli_report_on_a_raw_pair(tmp_path, capsys):
    """report on the rendered raw pair of tests/test_torch_pipeline.py: every
    section, the images, the embedded viewer and the metrics table."""
    K = np.array([[200.0, 0.0, 160.0], [0.0, 200.0, 120.0], [0.0, 0.0, 1.0]])
    left, right = synth.render_pair(K, synth.rotation_about((0.2, 1.0, 0.1), 2.0),
                                    np.array([-0.3, 0.02, 0.01]), 240, 320, seed=1)
    folder = tmp_path / "pair"
    folder.mkdir()
    Image.fromarray(left.numpy()).save(folder / "img1.jpg", quality=95)
    Image.fromarray(right.numpy()).save(folder / "img2.jpg", quality=95)
    np.savez(tmp_path / "calib.npz", K=K)
    out = tmp_path / "report.html"
    assert cli.main(["report", str(folder), "--calibration", str(tmp_path / "calib.npz"),
                     "--baseline", "0.3", "--ndisp", "32", "--device", "cpu",
                     "--output", str(out)]) == 0
    assert f"report -> {out}" in capsys.readouterr().out
    page = out.read_text()
    for section in ("Feature detection &amp; matching", "Rectification + geometry",
                    "Dense disparity", "3D reconstruction", "Pipeline metrics"):
        assert section in page
    assert page.count("data:image/png;base64,") == 8 and "<iframe class='viewer'" in page
    assert "time/rectify_pair_s" in page and "time/export_point_cloud_s" in page
