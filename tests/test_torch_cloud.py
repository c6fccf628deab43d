"""The points layer's wrappers (``ops/cuda/cloud.py``) on the CPU: what they
take, refuse and pass to the kernels (a fake kernels library patched in),
and the plain path the CPU keeps. The kernels themselves run in the ``gpu``
tests of ``tests/test_torch_gpu.py``."""

from __future__ import annotations

import ctypes
import math

import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu_torch import _build
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
from stereo_reconstruction_cv_tpu_torch.ops.cuda import cloud as CL
from stereo_reconstruction_cv_tpu_torch.parallel import streaming as ST
from stereo_reconstruction_cv_tpu_torch.utils import synth

from test_torch_launch import STREAM, fake_cuda  # noqa: F401  (the fixture)


def _rig_q(W=64, H=48):
    return synth.rectified_rig((W, H))[1].Q.numpy()


def _disparity(H=6, W=9, seed=0):
    g = torch.Generator().manual_seed(seed)
    d = torch.rand((H, W), generator=g) * 40 - 1
    d[0, :3] = 0.0
    return d


@pytest.fixture
def on_cpu_as_card(fake_cuda, monkeypatch):  # noqa: F811
    """The fake library, and CPU tensors taken as lying on one card."""
    monkeypatch.setattr(_build, "cuda_device", lambda what, *ts: torch.device("cpu"))
    monkeypatch.setattr(CL, "launches", {"reproject": 0, "compact": 0})
    return fake_cuda


def test_kernels_table_declares_the_points_layer():
    f = ctypes.c_float
    assert _build.KERNELS["srcv_cloud_reproject"] == [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [f] * 16
    assert _build.KERNELS["srcv_cloud_compact"] == [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2


@pytest.mark.parametrize("as_type", ["numpy", "float64 tensor", "float32 tensor", "list"])
def test_host_q_is_float32_row_major(as_type):
    Q = _rig_q()
    given = {"numpy": Q, "float64 tensor": torch.from_numpy(Q),
             "float32 tensor": torch.from_numpy(Q).float(), "list": Q.tolist()}[as_type]
    got = CL.host_q(given)
    assert got == [float(v) for v in Q.astype(np.float32).reshape(16)]
    assert got == torch.from_numpy(Q).to(torch.float32).reshape(16).tolist()


@pytest.mark.parametrize("bad", [np.eye(3), np.zeros(16), np.zeros((4, 4, 1))])
def test_host_q_refuses_a_matrix_that_is_not_4x4(bad):
    with pytest.raises(ValueError, match="4 x 4"):
        CL.host_q(bad)


def test_reproject_passes_q_by_value_and_counts_one_launch(on_cpu_as_card):
    Q = _rig_q()
    disp = _disparity(6, 9)
    out = CL.reproject_cuda(disp, Q)
    assert out.shape == (6, 9, 3) and out.dtype == torch.float32
    [(entry, args)] = on_cpu_as_card.calls
    assert entry == "srcv_cloud_reproject"
    assert args[:4] == (disp.data_ptr(), out.data_ptr(), 6, 9)
    assert list(args[4:20]) == [float(v) for v in Q.astype(np.float32).reshape(16)]
    assert args[20] == STREAM
    assert CL.launches == {"reproject": 1, "compact": 0}


def test_reproject_writes_into_the_out_it_is_given(on_cpu_as_card):
    pts = torch.empty((2, 6, 9, 3))
    assert CL.reproject_cuda(_disparity(6, 9), _rig_q(), out=pts[1]) is not None
    assert on_cpu_as_card.calls[0][1][1] == pts[1].data_ptr()


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 + 5])
def test_compact_sizes_its_work_space_by_tiles(on_cpu_as_card, n):
    """One call of srcv_cloud_compact a frame, with ceil(n / TILE) tiles of
    WORDS ballot words and one count each."""
    disp = torch.rand((1, n))
    pts = torch.zeros((1, n, 3))
    valid = torch.ones((1, n), dtype=torch.bool)
    CL.compact_cuda(disp, pts, valid)
    tiles = math.ceil(n / CL.TILE)
    [(entry, args)] = on_cpu_as_card.calls
    assert entry == "srcv_cloud_compact"
    assert args[6:] == (n, tiles * (CL.WORDS + 1), STREAM)
    assert CL.launches == {"reproject": 0, "compact": 1}


def test_compact_returns_its_buffers(on_cpu_as_card):
    disp, pts = _disparity(6, 9), torch.zeros((6, 9, 3))
    valid = torch.ones((6, 9), dtype=torch.bool)
    out, count = CL.compact_cuda(disp, pts, valid)
    assert out.shape == (54, 3) and out.dtype == torch.float32
    assert count.shape == (1,) and count.dtype == torch.int64
    args = on_cpu_as_card.calls[0][1]
    assert args[:6] == (disp.data_ptr(), valid.data_ptr(), pts.data_ptr(), out.data_ptr(),
                        count.data_ptr(), args[5])


@pytest.mark.parametrize("case,match", [
    ("float64", "float32"), ("rank 3", r"\(H, W\) float32"), ("out shape", "out must be"),
    ("out dtype", "out must be"), ("strided", "contiguous"), ("q", "4 x 4"),
])
def test_reproject_refuses_what_the_kernel_does_not_take(on_cpu_as_card, case, match):
    disp, out, Q = _disparity(6, 9), None, _rig_q()
    if case == "float64":
        disp = disp.double()
    elif case == "rank 3":
        disp = disp[None]
    elif case == "out shape":
        out = torch.empty((6, 9, 4))
    elif case == "out dtype":
        out = torch.empty((6, 9, 3), dtype=torch.float64)
    elif case == "strided":
        disp = _disparity(6, 18)[:, ::2]
    else:
        Q = Q[:3]
    with pytest.raises(ValueError, match=match):
        CL.reproject_cuda(disp, Q, out)
    assert on_cpu_as_card.calls == [] and CL.launches["reproject"] == 0


@pytest.mark.parametrize("case,match", [
    ("disp dtype", "disparity must be"), ("pts shape", "points must be"),
    ("pts dtype", "points must be"), ("valid dtype", "valid must be"),
    ("valid shape", "valid must be"), ("strided", "contiguous"),
])
def test_compact_refuses_what_the_kernels_do_not_take(on_cpu_as_card, case, match):
    disp, pts = _disparity(6, 9), torch.zeros((6, 9, 3))
    valid = torch.ones((6, 9), dtype=torch.bool)
    if case == "disp dtype":
        disp = disp.double()
    elif case == "pts shape":
        pts = pts[:, :8]
    elif case == "pts dtype":
        pts = pts.double()
    elif case == "valid dtype":
        valid = valid.to(torch.uint8)
    elif case == "valid shape":
        valid = valid.T
    else:
        pts = torch.zeros((6, 9, 6))[..., ::2]
    with pytest.raises(ValueError, match=match):
        CL.compact_cuda(disp, pts, valid)
    assert on_cpu_as_card.calls == [] and CL.launches["compact"] == 0


def test_cuda_wrappers_refuse_cpu_tensors_without_a_card():
    """No card, no fake: the device check raises before any library loads."""
    disp = _disparity()
    with pytest.raises(ValueError, match="^reproject: CUDA kernel called on .*one CUDA device"):
        CL.reproject_cuda(disp, _rig_q())
    with pytest.raises(ValueError, match="^compact: CUDA kernel called on"):
        CL.compact_cuda(disp, torch.zeros((6, 9, 3)), torch.ones((6, 9), dtype=torch.bool))


def test_a_map_on_neither_cpu_nor_card_takes_no_plain_path():
    """Only a CPU map takes the plain ops; any other device goes to the
    kernels, whose check refuses it."""
    meta = torch.empty((4, 5), device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        G.reproject_image_to_3d(meta, _rig_q())
    with pytest.raises(ValueError, match="one CUDA device"):
        ST.cloud_points(meta, torch.empty((4, 5, 3), device="meta"),
                        torch.empty((4, 5), dtype=torch.bool, device="meta"))


def _reproject_as_before(disparity, Q):
    """The plain reprojection as the port wrote it before the kernel."""
    H, W = disparity.shape
    dt = disparity.dtype
    Q = Q.to(dtype=dt)
    y = torch.arange(H, dtype=dt)[:, None]
    x = torch.arange(W, dtype=dt)[None, :]
    out = [x * Q[i, 0] + y * Q[i, 1] + disparity * Q[i, 2] + Q[i, 3] for i in range(4)]
    w = torch.where(out[3] == 0, torch.full_like(out[3], float("inf")), out[3])
    return torch.stack([out[0] / w, out[1] / w, out[2] / w], dim=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_reprojection_is_unchanged_on_the_cpu(dtype):
    """Bit for bit the ops as they were, for a numpy Q, a tensor Q and into out=."""
    Q = _rig_q(9, 6)
    disp = _disparity(6, 9).to(dtype)
    want = _reproject_as_before(disp, torch.from_numpy(Q))
    for q in (Q, torch.from_numpy(Q), torch.from_numpy(Q).float()):
        got = G.reproject_image_to_3d(disp, q)
        if not isinstance(q, torch.Tensor) or q.dtype == torch.float64:
            assert torch.equal(got, want)
        assert torch.equal(got, _reproject_as_before(disp, torch.as_tensor(q)))
    out = torch.full((3, 6, 9, 3), 5.0, dtype=dtype)
    view = out[1]
    assert G.reproject_image_to_3d(disp, Q, out=view) is view
    assert torch.equal(out[1], want)
    assert bool((out[0] == 5).all()) and bool((out[2] == 5).all())


def test_dense_batch_step_points_equal_each_pairs_reprojection():
    """The step writes each pair's points into the batch's tensor: the same
    bits as reprojecting each map alone."""
    from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig

    rng = np.random.default_rng(4)
    left = torch.from_numpy(rng.integers(0, 256, (2, 24, 48), dtype=np.uint8))
    right = torch.roll(left, -3, 2)
    Q = _rig_q(48, 24)
    cfg = SGBMConfig(num_disparities=16, num_directions=5, speckle_window_size=0)
    disp, pts, valid = ST.dense_batch_step(left, right, Q, cfg)
    assert pts.shape == (2, 24, 48, 3) and pts.dtype == torch.float32
    for d, p in zip(disp, pts):
        assert torch.equal(p, _reproject_as_before(d, torch.from_numpy(Q)))


@pytest.mark.parametrize("kind", ["random", "all invalid", "all kept", "empty"])
def test_plain_compaction_keeps_the_mask_in_row_major_order(kind):
    H, W = (0, 5) if kind == "empty" else (7, 11)
    g = torch.Generator().manual_seed(1)
    disp = torch.rand((H, W), generator=g) * 4 - 1
    pts = torch.randn((H, W, 3), generator=g)
    if H:
        pts[1, 2, 0] = float("nan")
        pts[3, 4, 2] = float("-inf")
    valid = torch.rand((H, W), generator=g) > 0.3
    if kind == "all invalid":
        valid[:] = False
    elif kind == "all kept":
        disp, valid, pts = disp.abs() + 1, torch.ones_like(valid), torch.nan_to_num(pts)
    points, count = ST.cloud_points(disp, pts, valid)
    mask = valid & torch.isfinite(pts).all(-1) & (disp > 0)
    assert count.dtype == torch.int64 and count.shape == (1,)
    assert points.shape == (H * W, 3)
    assert int(count) == int(mask.sum())
    assert torch.equal(points[: int(count)], pts[mask])
