"""The port's benchmark suite (``benchmarks.py``, the ``bench`` verb) on the CPU.

Config 1's step is held to the JAX reference's step at 96x160 x 16
disparities. The suite's mechanics run on stub configs, as
tests/test_bench_harness.py runs the reference's: the order 2, 1, 4, 3, 5,
the headline first and last, a failed config's error line and the non-zero
exit. Every config then runs for real at a small size, and each line must
carry the fields the reference's line of that metric has (read from the
reference's source), plus the port's: the backend, the card, the versions,
the data and the timed runs' spread.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu.ops import disparity as RD
from stereo_reconstruction_cv_tpu_torch import benchmarks as B
from stereo_reconstruction_cv_tpu_torch.tools.probe_sweep import textured_pair
from stereo_reconstruction_cv_tpu_torch.utils import synth

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FIELDS = {"backend", "card", "power_limit", "torch", "cuda", "data", "scene", "size",
               "first_s", "median_s", "min_s", "max_s", "runs"}


def _reference_fields() -> dict:
    """{metric: its keys} of every line literal in the reference's benchmarks.py."""
    tree = ast.parse((ROOT / "stereo_reconstruction_cv_tpu" / "benchmarks.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys:
                metric = node.values[keys.index("metric")]
                if isinstance(metric, ast.Constant):
                    out[metric.value] = set(keys)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_config1_map_is_bit_equal_to_the_reference_step():
    """benchmarks.py:133-144 on the CPU: block_sum(bt_cost_volume(...)[:, D:,
    :], 11) and wta_disparity(C, 0, 0). The disparities are bit-equal. The
    reference's WTA tests uniqueness on the int16 volume, where S * 100
    wraps (ROADMAP C, reference fault 9); the port widens C to int32 first,
    so its mask is the reference's on the widened volume."""
    D = 16
    left, right = textured_pair(np.random.default_rng(7), 96, 160, 5)
    l, r = jnp.asarray(left), jnp.asarray(right)
    C = RD.block_sum(RD.bt_cost_volume(RD.xsobel_clip(l, 63), RD.xsobel_clip(r, 63),
                                       l.astype(jnp.int32), r.astype(jnp.int32), D, 0)[:, D:, :], 11)
    ref_disp, _ = RD.wta_disparity(C, 0, 0)
    _, ref_valid = RD.wta_disparity(C.astype(jnp.int32), 0, 0)
    disp, valid = B.sad_wta_step(torch.from_numpy(left), torch.from_numpy(right), D)
    assert disp.dtype == torch.float32 and disp.shape == (96, 160 - D)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(ref_disp))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))


@pytest.fixture()
def stub_configs(monkeypatch):
    calls = []

    def line(c, metric):
        def run(**kwargs):
            calls.append(c)
            assert kwargs["device"] == "cpu"
            if c == 3:
                raise RuntimeError("kaput")
            return {"metric": metric, "value": float(c), "unit": "x", "vs_baseline": None}
        return run

    monkeypatch.setattr(B, "_CONFIGS", {1: line(1, "one"), 2: line(2, B.HEADLINE),
                                        3: line(3, "three"), 4: line(4, "four"),
                                        5: line(5, "five")})
    return calls


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


def test_default_order_prints_the_headline_first_and_last(stub_configs, capsys, monkeypatch):
    monkeypatch.setitem(B._CONFIGS, 3, lambda **kw: stub_configs.append(3) or {
        "metric": "three", "value": 3.0, "unit": "x", "vs_baseline": None})
    assert B.main(None, device="cpu") == 0
    assert stub_configs == [2, 1, 4, 3, 5]
    out = [x["metric"] for x in _lines(capsys)]
    assert out == [B.HEADLINE, "one", "four", "three", "five", B.HEADLINE]


def test_a_failed_config_prints_its_error_line_and_exits_non_zero(stub_configs, capsys):
    assert B.main([2, 3, 1], device="cpu") == 1
    out = _lines(capsys)
    assert stub_configs == [2, 3, 1]
    assert [x["metric"] for x in out] == [B.HEADLINE, "config3", "one", B.HEADLINE]
    assert out[1]["error"] == "RuntimeError: kaput" and out[1]["backend"] == "torch-cpu"


def test_the_card_asked_for_and_absent_fails_every_config(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert B.main([1, 2], device="cuda") == 1
    out = _lines(capsys)
    assert [x["metric"] for x in out] == ["config1", "config2"]
    assert all("cuda" in x["error"] for x in out)


def test_every_line_has_the_reference_fields_and_the_ports(monkeypatch):
    """Each config at a small size on the CPU (config 3's rig calibration,
    which tests/test_torch_calib.py and test_torch_frontends.py hold to the
    reference, stubbed to the anchor K)."""
    monkeypatch.setattr(B, "_live_calibration",
                        lambda dev, size: (synth.rectified_rig(size)[0].numpy(), 1.5, 2.5, 0.01))
    lines = [B.bench_config1("cpu", size=(160, 88), iters=1),
             B.bench_config2("cpu", size=(160, 88), iters=1),
             *B.bench_config3("cpu", size=(320, 184), iters=1),
             B.bench_config4("cpu", size=(320, 184), iters=1, pairs=1),
             B.bench_config5("cpu", size=(256, 144), decoder="libjpeg", n_pairs=2, windows=1)]
    ref = _reference_fields()
    assert sorted(x["metric"] for x in lines) == sorted(ref)
    for x in lines:
        missing = (ref[x["metric"]] | PORT_FIELDS) - set(x)
        assert not missing, (x["metric"], missing)
        assert x["backend"] == "torch-cpu" and x["data"] == "rendered" and x["vs_baseline"] is None
        assert x["min_s"] <= x["median_s"] <= x["max_s"] and np.isfinite(x["value"])
        json.dumps(x)
    c5 = lines[-1]
    assert c5["n_decodes"] == c5["n_pairs"] == 2 and c5["n_images_decoded"] == 4
    assert c5["n_h2d_events"] == 0 and c5["decoder"] == "libjpeg"
    assert c5["decode_psnr_db_min"] >= B.JPEG_MIN_PSNR_DB
    e2e = next(x for x in lines if x["metric"] == "e2e_4k_pair_to_cloud")
    assert (e2e["calib_s"], e2e["calib_first_s"], e2e["calib_mean_reproj_px"]) == (1.5, 2.5, 0.01)


def test_cli_bench_config1_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "stereo_reconstruction_cv_tpu_torch.cli", "bench",
                          "--device", "cpu", "--scale", "0.125", "1"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    (line,) = [json.loads(x) for x in out.stdout.splitlines()]
    assert line["metric"] == "sad_wta_720p_64disp" and line["size"] == [160, 88]
    assert line["backend"] == "torch-cpu" and line["value"] > 0
