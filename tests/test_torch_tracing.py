"""The port's spans (``utils.profiling.span``) on the CPU: nothing built while
no profiler records, the layer spans and their nesting while one does, the
loader's stalls, the operator's Chrome trace, and ``_build._compile`` shared
by threads."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from stereo_reconstruction_cv_tpu_torch import _build
from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig
from stereo_reconstruction_cv_tpu_torch.ops import rectify as RC
from stereo_reconstruction_cv_tpu_torch.parallel import streaming as ST
from stereo_reconstruction_cv_tpu_torch.parallel.prefetch import PrefetchLoader
from stereo_reconstruction_cv_tpu_torch.utils import profiling

H, W = 24, 64
CFG = SGBMConfig(num_disparities=16, num_directions=5)
Q = np.array([[1.0, 0, 0, -32.0], [0, 1.0, 0, -12.0], [0, 0, 0, 60.0], [0, 0, 1 / 0.1, 0]])


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H, W + 6), dtype=np.uint8)
    return base[:, 6:].copy(), base[:, :-6].copy()


def _chain():
    """remap -> dense_batch_step -> cloud_points on one tiny CPU pair."""
    left, right = (torch.from_numpy(f) for f in _pair())
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    grid = torch.stack([xs + 0.25, ys], -1)
    left, right = RC.remap_bilinear(left, grid), RC.remap_bilinear(right, grid)
    disp, pts, valid = ST.dense_batch_step(left[None], right[None], Q, CFG)
    return ST.cloud_points(disp[0], pts[0], valid[0])


@pytest.fixture(scope="module")
def jpeg_pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    pairs = []
    for k in range(4):
        row = []
        for side, img in zip("lr", _pair(k)):
            path = root / f"p{k}{side}.jpg"
            Image.fromarray(img).save(path, quality=95)
            row.append(str(path))
        pairs.append(tuple(row))
    return pairs


def _ranges(prof) -> list:
    """[(start, end, name)] of the "srcv." ranges of a finished profiler run."""
    return sorted((e.start_ns(), e.end_ns(), e.name()[len(profiling.SPAN_PREFIX):])
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(profiling.SPAN_PREFIX))


def _inside(ranges, child, parent) -> bool:
    """Every `child` range lies inside some `parent` range."""
    outer = [(s, e) for s, e, n in ranges if n == parent]
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer)
               for s, e, n in ranges if n == child)


def test_span_off_builds_no_record_function(monkeypatch, jpeg_pairs):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built while no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("sgbm") is profiling.span("rectify")
    with profiling.span("sgbm") as got:
        assert got is None
    points, count = _chain()
    assert points.shape == (H * W, 3) and int(count[0]) > 0
    with PrefetchLoader(jpeg_pairs[:2], batch_size=2, decoder="libjpeg", device="cpu") as loader:
        assert [tuple(c.shape) for c in next(iter(loader))] == [(2, H, W)] * 2


def test_layer_spans_nest_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _chain()
    ranges = _ranges(prof)
    names = [n for *_, n in ranges]
    assert names.count("rectify") == 2
    for name in ("sgbm", "sgbm.cost", "sgbm.aggregate", "sgbm.post", "cloud.reproject",
                 "cloud.compact"):
        assert names.count(name) == 1, (name, names)
    for child in ("sgbm.cost", "sgbm.aggregate", "sgbm.post"):
        assert _inside(ranges, child, "sgbm")
    span = {n: (s, e) for s, e, n in ranges}
    assert span["sgbm.cost"][1] <= span["sgbm.aggregate"][0] <= span["sgbm.post"][0]
    assert span["sgbm"][1] <= span["cloud.reproject"][0] < span["cloud.compact"][0]
    assert not _inside(ranges, "cloud.reproject", "sgbm")


def test_stream_reconstruct_spans_its_cloud_copies(tmp_path, jpeg_pairs):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        paths = ST.stream_reconstruct(jpeg_pairs[:3], Q, CFG, str(tmp_path), batch_size=2,
                                      device="cpu")
    assert len(paths) == 3
    ranges = _ranges(prof)
    names = [n for *_, n in ranges]
    assert names.count("input.take") == 2
    assert names.count("cloud.compact") == names.count("cloud.copy") == 3
    copies = [s for s, _, n in ranges if n == "cloud.copy"]
    compacts = [e for _, e, n in ranges if n == "cloud.compact"]
    assert all(c <= s for c, s in zip(compacts, copies))


def _mesh_step(B=4):
    """dense_batch_step over a 2x2 mesh of CPU devices on B tiny pairs."""
    from stereo_reconstruction_cv_tpu_torch.parallel import mesh as M

    frames = [_pair(k) for k in range(B)]
    left, right = (torch.from_numpy(np.stack([f[s] for f in frames])) for s in (0, 1))
    mesh = M.make_mesh(2, 2, devices=[torch.device("cpu")] * 4)
    return ST.dense_batch_step(left, right, Q, CFG, mesh)


def test_mesh_spans_build_no_record_function_while_off(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built while no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    disp, pts, valid = _mesh_step()
    assert len(disp) == len(pts) == len(valid) == 4


@pytest.mark.parametrize("B", [2, 4])
def test_mesh_spans_open_once_per_call(B):
    """A mesh step on B pairs: "mesh.exchange" once per _extend call (each
    frame's left and right blocks), "mesh.speckle.join" once per batch and
    "mesh.gather" once per data row, never per shard or per launch."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _mesh_step(B)
    ranges = _ranges(prof)
    names = [n for *_, n in ranges]
    assert names.count("mesh.exchange") == 2 * B
    assert names.count("mesh.speckle.join") == 1
    assert names.count("mesh.gather") == 2
    assert names.count("sgbm") == 2 * B and names.count("cloud.reproject") == 2
    join = next((s, e) for s, e, n in ranges if n == "mesh.speckle.join")
    assert all(e <= join[0] for s, e, n in ranges if n in ("sgbm", "mesh.exchange"))
    assert all(join[1] <= s for s, e, n in ranges if n == "mesh.gather")
    assert not _inside(ranges, "mesh.exchange", "sgbm")


@pytest.mark.parametrize("ready", [False, True])
def test_loader_records_a_stall_only_where_a_batch_was_not_ready(monkeypatch, jpeg_pairs, ready):
    """Slow decodes: the consumer comes for batch 0 right after submitting
    it, so at least that take stalls. Ready: each batch is loaded in the
    consumer's own submit, so every take finds it done."""
    from concurrent.futures import Future

    from torch.profiler import ProfilerActivity, profile

    class Inline:
        """An executor that runs each job in submit."""

        def submit(self, fn, *args):
            f = Future()
            f.set_result(fn(*args))
            return f

        def shutdown(self, **kwargs):
            pass

    if not ready:
        decode = PrefetchLoader._decode

        def slow(self, *args):
            time.sleep(0.05)
            return decode(self, *args)
        monkeypatch.setattr(PrefetchLoader, "_decode", slow)
    with PrefetchLoader(jpeg_pairs, batch_size=2, prefetch=1, decoder="libjpeg",
                        device="cpu") as loader:
        if ready:
            loader._batch_pool = Inline()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            batches = list(loader)
    assert len(batches) == 2
    ranges = _ranges(prof)
    names = [n for *_, n in ranges]
    assert names.count("input.take") == 2
    if ready:
        assert "input.stall" not in names
    else:
        assert 1 <= names.count("input.stall") <= 2
        assert _inside(ranges, "input.stall", "input.take")


def test_trace_writes_the_spans_into_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        _chain()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"srcv.rectify", "srcv.sgbm", "srcv.sgbm.aggregate", "srcv.cloud.compact"} <= names


def _stub_build(monkeypatch, tmp_path):
    """_compile with BUILD_DIR under tmp_path and a _run that writes each
    output it is asked for after a pause (a compiler's time), counting links."""
    links = []

    def run(cmds, log, name):
        for cmd in cmds:
            out = cmd[cmd.index("-o") + 1]
            time.sleep(0.05)
            with open(out, "w") as f:
                f.write(name)
            if "-shared" in cmd:
                links.append(out)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_run", run)
    src = tmp_path / "a.cc"
    src.write_text("int a;\n")
    return links, lambda: _build._compile(["cc"], (src,), ("-O2",), "libsrcv_test")


def test_compile_from_two_threads_builds_once(monkeypatch, tmp_path):
    links, compile_ = _stub_build(monkeypatch, tmp_path)
    start = threading.Barrier(2)
    results, errors = [], []

    def worker():
        start.wait()
        try:
            results.append(compile_())
        except Exception as e:  # noqa: BLE001 -- reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 2 and results[0] == results[1] and results[0].exists()
    assert len(links) == 1
    assert not list((tmp_path / "build").glob("*.tmp*"))


def test_compile_records_build_only_when_it_compiles(monkeypatch, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    links, compile_ = _stub_build(monkeypatch, tmp_path)
    for built in (True, False):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            compile_()
        assert [n for *_, n in _ranges(prof)] == (["build"] if built else [])
    assert len(links) == 1
