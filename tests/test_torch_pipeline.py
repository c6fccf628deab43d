"""Port vs JAX reference: the dense slice, pair -> disparity -> points -> PLY.

The reference runs its XLA path (backend="xla"); the port runs its plain
versions (CPU tensors). Disparity and masks are exact, points rtol 1e-5.
Also: the port's own g++ speckle build, the rectification and config
converters, the CLI, the PLY writer's bytes, and the import boundary: no
module of the port (nor chip_smoke.py) imports jax or the JAX package, and
importing the port pulls in neither jax nor PIL.
"""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stereo_reconstruction_cv_tpu import config as ref_config
from stereo_reconstruction_cv_tpu import native as ref_native
from stereo_reconstruction_cv_tpu.config import SGBMConfig
from stereo_reconstruction_cv_tpu.io import ply as PLY
from stereo_reconstruction_cv_tpu.ops import disparity as RD
from stereo_reconstruction_cv_tpu.ops import rectify as RR
from stereo_reconstruction_cv_tpu.pipeline import stages as RS
from stereo_reconstruction_cv_tpu_torch import cli, convert, native
from stereo_reconstruction_cv_tpu_torch import config as port_config
from stereo_reconstruction_cv_tpu_torch.io import ply as port_ply
from stereo_reconstruction_cv_tpu_torch.io import viewer as VW
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops import rectify as RC
from stereo_reconstruction_cv_tpu_torch.ops.cuda import cost as CK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import lr as LK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import op_chain as OC
from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import speckle as SPK
from stereo_reconstruction_cv_tpu_torch.pipeline import stages
from stereo_reconstruction_cv_tpu_torch.utils import synth
from stereo_reconstruction_cv_tpu_torch.utils.profiling import METRICS

ROOT = pathlib.Path(__file__).resolve().parent.parent
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
    port_cfg = convert.sgbm_config(cfg)
    d, v = DP.sgbm_disparity(torch.from_numpy(left), torch.from_numpy(right), port_cfg)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dr))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    assert 0.5 < v.float().mean() < 1.0
    if speckle:  # the filter removed something the unfiltered map kept
        _, v0 = DP.sgbm_disparity(torch.from_numpy(left), torch.from_numpy(right),
                                  port_cfg.with_(speckle_window_size=0))
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


def test_cli_reconstruct_on_cpu(tmp_path):
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
    from stereo_reconstruction_cv_tpu_torch.io.image import load_stereo_pair

    imL, imR = load_stereo_pair(str(pair))
    d = stages.disparity(imL, imR, ndisp=16, device="cpu")
    assert len(pts) == int((d > 0).sum()) > 0 and colors is not None
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
        "import stereo_reconstruction_cv_tpu_torch.ops.sift, stereo_reconstruction_cv_tpu_torch.ops.features\n"
        "import stereo_reconstruction_cv_tpu_torch.ops.matching, stereo_reconstruction_cv_tpu_torch.ops.robust\n"
        "import stereo_reconstruction_cv_tpu_torch.ops.epipolar, stereo_reconstruction_cv_tpu_torch.ops.fivepoint\n"
        "import stereo_reconstruction_cv_tpu_torch.ops.cuda.speckle\n"
        "import stereo_reconstruction_cv_tpu_torch.ops.cuda.op_chain\n"
        "import stereo_reconstruction_cv_tpu_torch.io.image, stereo_reconstruction_cv_tpu_torch.io.ply\n"
        "import stereo_reconstruction_cv_tpu_torch.tools.micro_wta\n"
        "import stereo_reconstruction_cv_tpu_torch.tools.micro_i16\n"
        "import stereo_reconstruction_cv_tpu_torch.tools.learned_pose\n"
        "import stereo_reconstruction_cv_tpu_torch.tools.time_config4\n"
        "import stereo_reconstruction_cv_tpu_torch.utils.draw\n"
        "import stereo_reconstruction_cv_tpu_torch.models.xfeat, stereo_reconstruction_cv_tpu_torch.models.checkpoint\n"
        "import stereo_reconstruction_cv_tpu_torch.calib.chessboard, stereo_reconstruction_cv_tpu_torch.ops.refine\n"
        "import stereo_reconstruction_cv_tpu_torch.calib.zhang, stereo_reconstruction_cv_tpu_torch.calib.stereo\n"
        "import stereo_reconstruction_cv_tpu_torch.pipeline.cache, stereo_reconstruction_cv_tpu_torch.utils.profiling\n"
        "import stereo_reconstruction_cv_tpu_torch.utils.capture, stereo_reconstruction_cv_tpu_torch.io.viewer\n"
        "import stereo_reconstruction_cv_tpu_torch.io.report, stereo_reconstruction_cv_tpu_torch.tools.calib_4k\n"
        "import stereo_reconstruction_cv_tpu_torch.benchmarks, stereo_reconstruction_cv_tpu_torch.utils.synth\n"
        "import stereo_reconstruction_cv_tpu_torch.parallel.prefetch\n"
        "import stereo_reconstruction_cv_tpu_torch.parallel.streaming\n"
        "import stereo_reconstruction_cv_tpu_torch.parallel.mesh\n"
        "import stereo_reconstruction_cv_tpu_torch.parallel.sgm_sharded\n"
        "import stereo_reconstruction_cv_tpu_torch.models.xfeat_train\n"
        "import stereo_reconstruction_cv_tpu_torch.tools.xfeat_warpcheck\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'stereo_reconstruction_cv_tpu' not in sys.modules\n"
        "assert not {'flax', 'optax'} & set(sys.modules)\n"
        "assert 'PIL' not in sys.modules\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_launch_counters_stay_zero_on_cpu():
    left, right = _pair(6)
    before = {**CK.launches, **SK.launches, **LK.launches, **SPK.launches, **OC.launches}
    assert set(SPK.launches) == {"speckle_labels", "speckle_keep"}
    for backend in ("exact", "propagate"):
        DP.compute_disparity_map(torch.from_numpy(left), torch.from_numpy(right), 16, 0,
                                 speckle_backend=backend)
    C = torch.zeros((4, 5, 16), dtype=torch.int16)
    SK.sgm_aggregate(C, 8, 32)
    SK.wta_volume(C, [C])
    SK.wta_packed(C, [C, C])
    OC.op_chain(torch.ones((2, 32), dtype=torch.int16), ("roll", "add", "min"))
    assert {**CK.launches, **SK.launches, **LK.launches, **SPK.launches, **OC.launches} == before
    assert all(v == 0 for v in before.values())


def test_unported_options_raise():
    """The reference's default config (speckle_backend "propagate") runs and
    equals the reference bit for bit; chunked scans stay a TPU-only option."""
    left, right = _pair(7)
    cfg = SGBMConfig(num_disparities=16)
    assert cfg.speckle_backend == "propagate"
    dr, vr = RD.sgbm_disparity(jnp.asarray(left), jnp.asarray(right), cfg.with_(backend="xla"))
    left, right = torch.from_numpy(left), torch.from_numpy(right)
    port_cfg = convert.sgbm_config(cfg)
    d, v = DP.sgbm_disparity(left, right, port_cfg)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dr))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    assert v.any()
    with pytest.raises(ValueError, match="speckle_backend"):
        DP.sgbm_disparity(left, right, port_cfg.with_(speckle_backend="flood"))
    with pytest.raises(ValueError, match="scan_chunk"):
        DP.sgbm_disparity(left, right,
                          convert.sgbm_config(SGBMConfig(num_disparities=16, scan_chunk=64)))


def _imports(path: pathlib.Path):
    """(line, module) of every import statement in a Python file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, "." * node.level + (node.module or "")


def test_port_and_chip_smoke_import_nothing_of_jax_or_the_reference():
    """Nor flax or optax; nor does the package import chip_smoke.py, whose
    scenes it keeps in utils/synth.py."""
    package = sorted((ROOT / "stereo_reconstruction_cv_tpu_torch").rglob("*.py"))
    files = package + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for line, mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "stereo_reconstruction_cv_tpu")
           or mod.startswith(".") or (f in package and mod.split(".")[0] == "chip_smoke")]
    assert not bad, bad


def test_sharded_sgbm_runs_the_single_device_stages_not_its_own():
    """parallel/sgm_sharded.py reaches the cost and post stages through
    ops.disparity's public stages: it imports neither kernel module of those
    stages and reads no private name of ops.disparity."""
    path = ROOT / "stereo_reconstruction_cv_tpu_torch" / "parallel" / "sgm_sharded.py"
    bad = [f"{line}: imports {mod}" for line, mod in _imports(path)
           if mod.endswith(("ops.cuda.cost", "ops.cuda.lr"))]
    tree = ast.parse(path.read_text())
    bad += [f"{node.lineno}: from ops.cuda import {a.name}" for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and (node.module or "").endswith("ops.cuda")
            for a in node.names if a.name in ("cost", "lr")]
    bad += [f"{node.lineno}: DP.{node.attr}" for node in ast.walk(tree)
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "DP" and node.attr.startswith("_")]
    assert not bad, bad
    uses = {node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "DP"}
    assert {"validate", "sgbm_cost", "sgbm_post", "margin", "sgbm_disparity"} <= uses


def test_port_sgbm_config_equals_the_reference_field_by_field():
    ref = SGBMConfig()
    ours = port_config.SGBMConfig()
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert convert.sgbm_config(ref) == ours
    custom = ref.with_(num_disparities=64, num_directions=8, speckle_backend="exact", p2=1000)
    assert dataclasses.asdict(convert.sgbm_config(custom)) == dataclasses.asdict(custom)
    assert convert.sgbm_config(custom) == ours.with_(num_disparities=64, num_directions=8,
                                                     speckle_backend="exact", p2=1000)
    # The whole pipeline tree, nested classes included.
    ref_p, ours_p = ref_config.PipelineConfig(), port_config.PipelineConfig()

    def names(cfg):
        return [(f.name, names(getattr(cfg, f.name)) if dataclasses.is_dataclass(getattr(cfg, f.name))
                 else None) for f in dataclasses.fields(cfg)]

    assert names(ours_p) == names(ref_p)
    assert dataclasses.asdict(ours_p) == dataclasses.asdict(ref_p)
    assert convert.pipeline_config(ref_p) == ours_p == port_config.DEFAULT
    custom_p = dataclasses.replace(
        ref_p, image_size=(640, 480),
        match=ref_config.MatchConfig(max_keypoints=1024, ratio_geometry=0.65),
        robust=ref_config.RobustConfig(num_hypotheses=256, e_threshold_px=2.0),
        rectify=ref_config.RectifyConfig(alpha=0.0),
        calibration=ref_config.CalibrationConfig(chessboard=ref_config.ChessboardConfig(cols=8)),
        sgbm=custom)
    carried = convert.pipeline_config(custom_p)
    assert dataclasses.asdict(carried) == dataclasses.asdict(custom_p)
    assert isinstance(carried.calibration.chessboard, port_config.ChessboardConfig)
    assert isinstance(carried.sgbm, port_config.SGBMConfig)


def test_port_ply_writer_bytes_equal_the_reference(tmp_path):
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(57, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (57, 3), dtype=np.uint8)
    for c in (None, colors, colors.astype(np.float64) * 1.5):
        for binary in (True, False):
            a, b = tmp_path / "ref.ply", tmp_path / "port.ply"
            assert PLY.write_ply(str(a), pts, c, binary) == port_ply.write_ply(str(b), pts, c, binary)
            assert a.read_bytes() == b.read_bytes()
            (p_ref, c_ref), (p, c_port) = PLY.read_ply(str(a)), port_ply.read_ply(str(b))
            np.testing.assert_array_equal(p, p_ref)
            assert (c_port is None) == (c_ref is None)
            if c_ref is not None:
                np.testing.assert_array_equal(c_port, c_ref)


# ---------------------------------------------------------------------------
# The sparse verbs on a raw pair (the ray-cast scene of chip_smoke.py)
# ---------------------------------------------------------------------------

RAW_K = np.array([[200.0, 0.0, 160.0], [0.0, 200.0, 120.0], [0.0, 0.0, 1.0]])
RAW_T = np.array([-0.3, 0.02, 0.01])


@pytest.fixture()
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def raw_pair(tmp_path_factory):
    """A raw 240x320 pair folder (planes at 2.5-5 m, a 2 degree rotation,
    T = (-0.3, 0.02, 0.01) m; JPEG-compressed) and a calibration .npz."""
    R = synth.rotation_about((0.2, 1.0, 0.1), 2.0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        left, right = synth.render_pair(RAW_K, R, RAW_T, 240, 320, seed=1)
    finally:
        torch.set_num_threads(n)
    folder = tmp_path_factory.mktemp("raw") / "pair"
    folder.mkdir()
    Image.fromarray(left.numpy()).convert("RGB").save(folder / "img1.jpg", quality=95)
    Image.fromarray(right.numpy()).convert("RGB").save(folder / "img2.jpg", quality=95)
    calib = folder.parent / "calibration.npz"
    np.savez(calib, K=RAW_K, dist=np.zeros(5))
    return str(folder), str(calib), R


def _rotation_error_deg(Ra, Rb):
    return np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)))


def test_cli_match_on_a_raw_pair(raw_pair, tmp_path, capsys, one_thread):
    folder, _, _ = raw_pair
    out = tmp_path / "matches.npz"
    assert cli.main(["match", folder, "--device", "cpu", "--save", str(out)]) == 0
    assert "good matches (ratio 0.75)" in capsys.readouterr().out
    with np.load(out) as z:
        assert z["keypoints1"].shape == (2048, 2) and z["descriptors1"].shape == (2048, 128)
        assert int(z["match_mask"].sum()) > 100
    vis = stages.detect_match(folder, with_visualizations=True, device="cpu")
    assert vis["Left Keypoints"].shape == (360, 640, 3) and vis["Good Matches"].shape == (360, 1280, 3)


def test_cli_geometry_with_a_calibration_file(raw_pair, capsys, one_thread):
    folder, calib, R = raw_pair
    assert cli.main(["geometry", folder, "--calibration", calib, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "Rotation Matrix" in text and "E inliers" in text
    g = stages.estimate_geometry(folder, camera_matrix=RAW_K, device="cpu")
    assert _rotation_error_deg(g["Rotation Matrix"], R) < 0.1
    t = g["Translation Vector"].ravel()
    assert np.degrees(np.arccos(t @ RAW_T / np.linalg.norm(RAW_T))) < 2
    assert g["num_inliers_E"] > 0.5 * g["num_matches"] > 100


def test_cli_rectify_writes_its_files(raw_pair, tmp_path, capsys, one_thread):
    folder, calib, _ = raw_pair
    outdir = tmp_path / "rect"
    argv = ["rectify", folder, "--calibration", calib, "--undistort", "--baseline", "0.3",
            "--device", "cpu", "--outdir", str(outdir)]
    assert cli.main(argv) == 0
    slope = float(capsys.readouterr().out.split("after rectification:")[1].split()[0])
    assert slope < 0.02
    names = ("left_rectified.jpg", "right_rectified.jpg", "left_epilines_before.png",
             "right_points_before.png", "left_epilines_after.png", "right_points_after.png")
    assert all((outdir / n).exists() for n in names)
    with np.load(outdir / "rectification.npz") as z:
        assert z["Q"].shape == (4, 4) and z["P2"].shape == (3, 4)
        assert abs(1 / z["Q"][3, 2]) == pytest.approx(0.3, rel=1e-9)


def test_cli_triangulate_writes_a_sparse_cloud(raw_pair, tmp_path, one_thread):
    folder, calib, _ = raw_pair
    out = tmp_path / "sparse.ply"
    argv = ["triangulate", folder, "--calibration", calib, "--baseline",
            str(np.linalg.norm(RAW_T)), "--device", "cpu", "--output", str(out)]
    assert cli.main(argv) == 0
    pts, _ = PLY.read_ply(str(out))
    assert len(pts) > 100 and np.isfinite(pts).all()
    assert 2.4 < np.median(pts[:, 2]) < 5.1


def test_cli_reconstruct_from_a_raw_pair(raw_pair, tmp_path, one_thread):
    """No --rectification: geometry, rectification, SGBM, reprojection, PLY."""
    folder, calib, _ = raw_pair
    out = tmp_path / "dense.ply"
    argv = ["reconstruct", folder, "--calibration", calib, "--baseline",
            str(np.linalg.norm(RAW_T)), "--ndisp", "32", "--device", "cpu", "--output", str(out)]
    assert cli.main(argv) == 0
    pts, colors = PLY.read_ply(str(out))
    assert len(pts) > 0.3 * 240 * (320 - 32) and colors is not None
    assert 2.4 < np.median(pts[:, 2]) < 5.1


def test_unported_options_are_refused_with_their_queue_item(raw_pair, tmp_path, capsys,
                                                           monkeypatch, one_thread):
    """The options once refused with exit 2 and their queue item (--cache,
    --viewer, --metrics; ROADMAP A.15) now run on the same verbs: the cache
    misses then hits with the same output, the viewer holds the cloud's
    points, the metrics file the verb's stages."""
    folder, calib, _ = raw_pair
    monkeypatch.chdir(tmp_path)  # --cache without DIR writes ./.stereo_tpu_cache
    outs = []
    for _ in range(2):
        assert cli.main(["geometry", folder, "--cache", "--device", "cpu"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "E inliers" in outs[0]
    assert [f.split("-")[0] for f in os.listdir(tmp_path / ".stereo_tpu_cache")] == ["geometry"]
    rect = []
    for i in range(2):
        argv = ["rectify", folder, "--cache", str(tmp_path / "c"), "--device", "cpu",
                "--outdir", str(tmp_path / f"r{i}")]
        assert cli.main(argv) == 0
        with np.load(tmp_path / f"r{i}" / "rectification.npz") as z:
            rect.append({k: z[k] for k in z.files})
    assert all(np.array_equal(rect[0][k], rect[1][k]) for k in rect[0])
    assert [f.split("-")[0] for f in os.listdir(tmp_path / "c")] == ["rectify"]
    base = str(np.linalg.norm(RAW_T))
    assert cli.main(["triangulate", folder, "--calibration", calib, "--baseline", base, "--viewer",
                     "v.html", "--device", "cpu", "--output", "s.ply"]) == 0
    pts, _ = PLY.read_ply("s.ply")
    np.testing.assert_array_equal(VW.read_html_viewer("v.html")[0], pts)
    assert cli.main(["reconstruct", folder, "--calibration", calib, "--baseline", base, "--ndisp",
                     "32", "--viewer", "d.html", "--device", "cpu", "--output", "d.ply"]) == 0
    pts, colors = PLY.read_ply("d.ply")
    vp, vc = VW.read_html_viewer("d.html")
    np.testing.assert_array_equal(vp, pts)
    np.testing.assert_array_equal(vc, colors)
    capsys.readouterr()
    METRICS.reset()
    assert cli.main(["--metrics", "m.json", "match", folder, "--device", "cpu"]) == 0
    assert "metrics -> m.json" in capsys.readouterr().out
    m = json.loads((tmp_path / "m.json").read_text())
    assert m["time/detect_match_calls"] == 1 and m["detect_match/num_good_matches"] > 100


def test_cli_match_and_geometry_learned(raw_pair, tmp_path, capsys, one_thread):
    """--learned with the shipped weights; --model takes an .npz export and
    refuses the reference's orbax directory with the export hint."""
    folder, calib, R = raw_pair
    out = tmp_path / "learned.npz"
    assert cli.main(["match", folder, "--learned", "--device", "cpu", "--save", str(out)]) == 0
    with np.load(out) as z:
        assert z["keypoints1"].shape == (2048, 2) and z["descriptors1"].shape == (2048, 64)
        assert int(z["match_mask"].sum()) > 300
    capsys.readouterr()
    from stereo_reconstruction_cv_tpu_torch.models.checkpoint import default_checkpoint

    assert cli.main(["geometry", folder, "--learned", "--model", default_checkpoint(),
                     "--calibration", calib, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    R_est = np.array([[float(v) for v in line.strip(" []").split()]
                      for line in text.split("== Rotation Matrix ==")[1].split("==")[0].strip().splitlines()])
    assert _rotation_error_deg(R_est, R) < 1.5 and "E inliers" in text
    for verb in ("match", "geometry"):
        argv = [verb, folder, "--learned", "--model", str(ROOT / "checkpoints" / "xfeat_v4"),
                "--device", "cpu"]
        assert cli.main(argv) == 2
        assert "tests/test_torch_xfeat.py CHECKPOINT_DIR OUT.npz" in capsys.readouterr().err


def test_cli_reference_range_fallbacks(capsys):
    import argparse

    args = argparse.Namespace(baseline=-1.0, contrast_threshold=0.5)
    cli._validate_reference_ranges(args)
    assert args.baseline == 0.1 and args.contrast_threshold == 0.04
    err = capsys.readouterr().err
    assert "Invalid baseline value" in err and "Invalid contrast threshold" in err
    args = argparse.Namespace(baseline=0.14, contrast_threshold=0.02)
    cli._validate_reference_ranges(args)
    assert args.baseline == 0.14 and args.contrast_threshold == 0.02


def test_probe_sparse_needs_a_card(capsys):
    from stereo_reconstruction_cv_tpu_torch.tools import probe_sparse

    if torch.cuda.is_available():
        pytest.skip("the probe runs on the card here")
    assert probe_sparse.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
