"""The block-matching cell (``hd720_bm64.live``) on the CPU at a tiny size:
a sound run is ``correct``, the control and a broken chain are not; the
"bm" chain's traced layers; the layer's and the WTA pass's work at the
cell's shapes; the metric readers on a trace with and without the layer and
its WTA kernel."""

import json
import types
from pathlib import Path

import pytest
import torch

from benchmark import control, harness, work, work_bm
from benchmark.trace import Spans, Summary

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELL = "hd720_bm64.live"


def run_tiny(tiny, chain_cls=None, traced=False, seed=2**31 + 12345, **mix):
    return harness.run_cell(CELL, seed, 0.4, traced, CPU, 0.0, chain_cls=chain_cls,
                            overrides=tiny("hd720_bm64", **mix))


def test_sound_run_is_correct(tiny):
    r = run_tiny(tiny)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"pairs_per_s", "latency_p95_ms", "setup_s"} <= set(r["metrics"])
    assert set(r["checks"]) == {"rect_px", "map_px", "cloud_count_diff", "cloud_err"}


def test_control_is_not_correct(tiny):
    for seed in (1, 2, 3):
        numbers, limits = control.control_numbers(CELL, seed, CPU, overrides=tiny("hd720_bm64"))
        assert any(v > limits[k] for k, v in numbers.items()), numbers


class _Chain(harness.piece("chains", "bm").Chain):
    """The port's chain with one fault planted underneath."""
    fault = None

    def dense(self, lefts, rights):
        last = getattr(self, "_last", None)
        disp, pts, valid = super().dense(lefts, rights)
        if self.fault == "altered":  # one disparity changed where it is produced
            disp = disp.clone()
            disp[:, 20, 100] += 0.5
        self._last = (disp, pts, valid)
        if self.fault == "stale" and last is not None:
            return last  # the outputs the call before wrote
        return disp, pts, valid


@pytest.mark.parametrize("fault", ["stale", "altered"])
def test_broken_chain_is_not_correct(tiny, fault):
    broken = type("Broken", (_Chain,), {"fault": fault})
    for seed in (2**31 + 12345, 7, 4_000_000_001):
        r = run_tiny(tiny, chain_cls=broken, pairs=3, seed=seed)
        assert not r["correct"], (seed, r["checks"])


def test_traced_layers_are_the_sgbm_chains(tiny):
    """The chain's traced layers open bench.sgbm and bench.cloud once a
    pair, as the "sgbm" chain's do, and put the program's functions back on
    exit."""
    from torch.profiler import ProfilerActivity, profile

    from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
    from stereo_reconstruction_cv_tpu_torch.ops import geometry as G

    _, config, mix, _, _ = harness.load_cell(CELL, overrides=tiny("hd720_bm64"))
    from benchmark import traffic
    rig, pairs = traffic.render(config, mix, 3, CPU)
    chain = harness.piece("chains", "bm").Chain(config, *rig, rectify=True, device=CPU)
    frames = [torch.from_numpy(f)[None] for f in pairs[0]]
    originals = (DP.sgbm_disparity, G.reproject_image_to_3d)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with chain.traced_layers(Spans(True)):
            chain.dense(*frames)
    assert (DP.sgbm_disparity, G.reproject_image_to_3d) == originals
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("bench.")]
    assert sorted(names) == ["bench.cloud", "bench.sgbm"]


def test_work_at_the_cell_shapes():
    config = json.loads((ROOT / "benchmark" / "configs" / "hd720_bm64.json").read_text())
    assert (config["width"], config["height"]) == (1280, 720)
    assert config["sgbm"]["num_directions"] == 0 and config["sgbm"]["num_disparities"] == 64
    cells = 720 * (1280 - 64) * 64
    layer = work.sgbm_work(720, 1280, config["sgbm"])
    assert layer["ops"] == cells * (23 + 6) + 720 * 1280 * (20 + 10)
    assert layer["bound_by"] == "operations"
    assert layer["least_s"] == pytest.approx(24.666e-6, rel=1e-4)
    wta = work_bm.wta_work(720, 1280, config["sgbm"])
    assert wta["ops"] == cells * 6
    assert wta["bytes"] == cells * 2 + 720 * 1216 * 13 == 123_448_320
    assert wta["bound_by"] == "bytes"
    assert wta["least_s"] == pytest.approx(36.850e-6, rel=1e-4)


WTA = "void (anonymous namespace)::wta_cost_kernel<8, 1, true>((anonymous namespace)::WtaArgs)"


def _readings(range_s, issued=10, config=None, device_ops=()):
    trace = Summary(window_s=1.0, busy_s=0.5, items=100, range_s=range_s,
                    device_ops=[list(op) for op in device_ops])
    window = types.SimpleNamespace(issued=issued)
    return harness.Readings(cell={}, config=config or {}, mix={}, setup_s=1.0, window=window,
                            peak_bytes=0, trace=trace)


def test_metric_readers():
    config = json.loads((ROOT / "benchmark" / "configs" / "hd720_bm64.json").read_text())
    ops = [("void cost_volume_u8x2_kernel<true>(...)", 0.003), (WTA, 0.001)]
    r = _readings({"sgbm": 0.005, "cloud": 0.002}, config=config, device_ops=ops)
    assert harness.reader("device_ms.bm")(r) == pytest.approx(0.5)
    assert harness.reader("device_ms.bm.wta")(r) == pytest.approx(0.1)
    least = work.sgbm_work(720, 1280, config["sgbm"])["least_s"]
    assert harness.reader("bm_roofline")(r) == pytest.approx(100 * least / 0.5e-3)
    least = work_bm.wta_work(720, 1280, config["sgbm"])["least_s"]
    assert harness.reader("wta_roofline")(r) == pytest.approx(100 * least / 0.1e-3)
    # the one- and two-volume WTA kernel is another pass: not read
    r = _readings({"sgbm": 0.004}, config=config,
                  device_ops=[("void (anonymous namespace)::wta_kernel<4>(WtaArgs)", 0.001)])
    assert harness.reader("device_ms.bm.wta")(r) is None
    assert harness.reader("wta_roofline")(r) is None
    assert harness.reader("device_ms.bm")(r) == pytest.approx(0.4)
    # a trace without the layer (a program that cannot run the cell): nothing to read
    r = _readings({}, config=config)
    for metric in ("device_ms.bm", "bm_roofline", "device_ms.bm.wta", "wta_roofline"):
        assert harness.reader(metric)(r) is None
