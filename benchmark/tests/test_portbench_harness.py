"""The harness on the CPU at a tiny size: pieces found by name, the run
refused without a card, the import check, and ``correct`` coming out false
under the control and under each fault a cell can have."""

import ast
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import control, harness, run

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
LIVE, BACKLOG = "hd720_hh128.live", "logitech4k_sgbm256.jpeg_backlog"


def run_tiny(tiny, cell, chain_cls=None, traced=False, root=ROOT, seed=2**31 + 12345, **mix):
    mix = {"decoder": "libjpeg", **mix} if "backlog" in cell else mix
    config = cell.split(".")[0] if root == ROOT else "hd720_hh128"
    return harness.run_cell(cell, seed, 0.4, traced, CPU, 0.0, root=root,
                            chain_cls=chain_cls, overrides=tiny(config, **mix))


@pytest.mark.parametrize("cell", [LIVE, BACKLOG])
def test_sound_run_is_correct(tiny, cell):
    r = run_tiny(tiny, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert {"pairs_per_s", "setup_s"} <= set(r["metrics"])


STUB_LOOP = '''"""A fixed-rate open loop: a pair arrives every 1 / rate seconds and is
handed over at its arrival, or once the pair before has finished where that
is later; its latency counts from its arrival."""

import time

import torch

from benchmark import traffic


def prepare(run):
    traffic.warm_host_pairs(run)


def window(run, seconds):
    host = [tuple(torch.from_numpy(f) for f in p) for p in run.pairs]
    lat, done, i = [], [], 0
    with run.span("window"):
        t_start = time.perf_counter()
        t_end = t_start + seconds
        while True:
            arrival = t_start + i / run.mix["rate"]
            if arrival >= t_end:
                break
            time.sleep(max(0.0, arrival - time.perf_counter()))
            k = i % len(host)
            left, right = (f.to(run.device) for f in host[k])
            ((event, make),) = traffic.run_pairs(run.chain, run.span, [left], [right], [k])
            traffic.wait(event)
            done.append(time.perf_counter())
            lat.append(done[-1] - arrival)
            run.sampler.offer([make])
            i += 1
    return traffic.Window(seconds=t_end - t_start, issued=i,
                          completed=sum(t <= t_end for t in done), finished=len(done),
                          latencies_s=lat, loader_wait_s=None, counts_ok=True)
'''


def test_stub_pieces_are_found(tmp_path, tiny):
    """A configuration with a chain and a reference of its own, a mix with a
    loop of its own (a fixed-rate open loop) and a per-layer metric added as
    new files and new BENCHMARK.json entries only."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "benchmark"
    config = json.loads((bench / "configs" / "hd720_hh128.json").read_text())
    config["name"] = "stub_cfg"
    config["chain"] = "stub_chain"
    (bench / "configs" / "stub_cfg.json").write_text(json.dumps(config))
    (bench / "chains" / "stub_chain.py").write_text(
        '"""The sgbm chain under another name."""\n\nfrom benchmark import harness\n\n'
        'Chain = harness.piece("chains", "sgbm").Chain\n')
    (bench / "reference" / "stub_chain.py").write_text(
        '"""The sgbm reference under another name."""\n\n'
        'from benchmark.reference.sgbm import maps  # noqa: F401\n')
    (bench / "loops" / "stub_open.py").write_text(STUB_LOOP)
    (bench / "mixes" / "stub_mix.json").write_text(json.dumps(
        {"why": "stub", "loop": "stub_open", "pairs": 3, "rig": "raw", "rate": 20.0}))
    (bench / "metrics" / "stub_pairs_issued.py").write_text(
        '"""Pairs issued in the window."""\n\n\ndef read(r):\n    return float(r.window.issued)\n')
    spec["configs"].append({"name": "stub_cfg", "source": "https://example.org/stub",
                            "file": "benchmark/configs/stub_cfg.json", "reduced": [],
                            "why": "stub"})
    spec["workloads"].append({"name": "stub_cfg.stub_mix", "config": "stub_cfg",
                              "traffic": "stub_mix", "chips": 1, "why": "stub"})
    spec["per_layer"].append({"name": "stub_pairs_issued", "unit": "pairs", "better": "higher",
                              "source": "host_clock", "layer": "device", "moves": "pairs_per_s",
                              "workloads": ["stub_cfg.stub_mix"]})
    spec["end_to_end"] = [dict(m, workloads=m["workloads"] + ["stub_cfg.stub_mix"])
                          if m["name"] == "latency_p95_ms" else m for m in spec["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    traced = run_tiny(tiny, "stub_cfg.stub_mix", traced=True, root=tmp_path)
    assert traced["correct"], traced["checks"]
    # at 20 pairs/s over 0.4 s: 8 arrivals, each handed over when it arrives or later
    assert traced["metrics"]["stub_pairs_issued"]["value"] == traced["attempted"] == 8
    assert "breakdown" in traced and "busy_s" in traced["device"]
    plain = run_tiny(tiny, "stub_cfg.stub_mix", root=tmp_path)
    assert plain["correct"] and plain["metrics"]["latency_p95_ms"]["value"] > 0


def test_run_exits_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", LIVE, "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_nothing_run_imports_is_jax():
    """A fresh interpreter imports everything a run imports (the harness,
    every chain, loop and metric reader, the control):
    no top-level module is jax, jaxlib, flax or the JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, run, control\n"
        "import pathlib\n"
        "for p in sorted(pathlib.Path(%r).glob('benchmark/*/*.py')):\n"
        "    if p.parent.name in ('metrics', 'loops', 'chains'):\n"
        "        harness.piece(p.parent.name, p.stem)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % (str(ROOT), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "stereo_reconstruction_cv_tpu_torch" in top
    assert not top & set(run.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.reference import sgbm, rig\n"
            "from benchmark import scene, work\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & {"stereo_reconstruction_cv_tpu_torch", *run.FORBIDDEN}
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0].startswith("stereo_reconstruction_cv_tpu")
                           for n in names), path


@pytest.mark.parametrize("cell", [LIVE, BACKLOG])
def test_control_is_not_correct(tiny, cell):
    mix = {"decoder": "libjpeg"} if "backlog" in cell else {}
    for seed in (1, 2, 3):
        numbers, limits = control.control_numbers(cell, seed, CPU,
                                                  overrides=tiny(cell.split(".")[0], **mix))
        assert any(v > limits[k] for k, v in numbers.items()), numbers


class _Chain(harness.piece("chains", "sgbm").Chain):
    """The port's chain with one fault planted underneath."""
    fault = None

    def rectify(self, left, right):
        if self.fault == "unchanged":  # the step hands its input on unchanged
            return left, right
        return super().rectify(left, right)

    def dense(self, lefts, rights):
        last = getattr(self, "_last", None)
        disp, pts, valid = super().dense(lefts[:1] if self.fault == "half" else lefts,
                                         rights[:1] if self.fault == "half" else rights)
        if self.fault == "half":  # the batch's first pair stands in for the rest
            disp, pts, valid = (t.expand(lefts.shape[0], *t.shape[1:]) for t in (disp, pts, valid))
        if self.fault == "altered":  # one disparity changed where it is produced
            disp = disp.clone()
            disp[:, 20, 100] += 0.5
        self._last = (disp, pts, valid)
        if self.fault == "unchanged" and last is not None:
            # the step's outputs left as the call before wrote them (a
            # launch skipped over a reused buffer)
            return last
        return disp, pts, valid


def broken(fault: str):
    return type("Broken", (_Chain,), {"fault": fault})


@pytest.mark.parametrize("cell, fault", [(LIVE, "unchanged"), (LIVE, "altered"),
                                         (BACKLOG, "unchanged"), (BACKLOG, "half"),
                                         (BACKLOG, "altered")])
def test_fault_is_not_correct(tiny, cell, fault):
    """At the configuration's own number of checked batches, on three seeds:
    4K checks one batch, so a fault in half of a batch of 2 is seen only
    because every pair of the sampled batch is checked."""
    # 3 distinct pairs in batches of 2, so no two consecutive batches are alike
    for seed in (2**31 + 12345, 7, 4_000_000_001):
        r = run_tiny(tiny, cell, chain_cls=broken(fault), pairs=3, seed=seed)
        assert not r["correct"], (seed, r["checks"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [LIVE, BACKLOG])
def test_tiny_run_on_the_card(card, tiny, cell):
    mix = {} if "backlog" not in cell else {"decoder": "nvjpeg"}
    r = harness.run_cell(cell, 5, 0.5, True, card, 0.0, overrides=tiny(cell.split(".")[0], **mix))
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0 and 0 < r["metrics"]["sgbm_roofline"]["value"] < 100
