"""The harness: finds a cell's pieces by name, sets it up, runs its window,
reads its metrics and judges its outputs.

Everything that belongs to one configuration, one traffic mix, one loop or
one metric is a file of its own, found by the name ``BENCHMARK.json`` or
the mix gives it:

- ``configs/<config>.json`` (the entry's ``file``): the sizes, the chain
  and its parameters, the rig, the batches to check and each checked
  number's limit;
- ``chains/<chain>.py`` (the configuration's ``chain``): the program's
  ``Chain``, and ``reference/<chain>.py`` its plain reference (``check.py``);
- ``mixes/<traffic>.json``: the mix's parameters, read by ``traffic.py``;
- ``loops/<loop>.py`` (the mix's ``loop``): ``prepare(run)`` and
  ``window(run, seconds)``, as ``traffic.py`` describes them;
- ``metrics/<metric>.py``: a reader ``read(r)`` of a ``Readings`` that
  returns the metric's value, or None where the run has nothing to read.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from benchmark import check, traffic
from benchmark.trace import Spans, Summary, summarize

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Readings:
    """What a metric reader reads."""
    cell: dict
    config: dict
    mix: dict
    setup_s: float
    window: traffic.Window
    peak_bytes: int
    trace: Summary | None


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT, overrides=None) -> tuple:
    """(cell, configuration, mix, end-to-end metric entries, per-layer
    metric entries) of the cell `name`, the metrics those that it reports.
    `overrides` replaces top-level keys of the configuration or the mix
    (the tests' small sizes)."""
    spec = load_spec(root)
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "mixes" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    for key, value in (overrides or {}).items():
        (config if key in config else mix)[key] = value

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return cell, config, mix, reported(spec["end_to_end"]), reported(spec["per_layer"])


def piece(kind: str, name: str, root: Path = ROOT):
    """The module benchmark/<kind>/<name>.py."""
    path = root / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = ROOT):
    """The `read` function of metrics/<metric>.py."""
    return piece("metrics", metric, root).read


def read_metrics(entries: list, r: Readings, root: Path = ROOT) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"], root)(r)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"metric {m['name']} read {value}")
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, traced: bool, device: torch.device,
             t_process: float, root: Path = ROOT, chain_cls=None, overrides=None) -> dict:
    """One run of a cell: set-up, warm-up, the window, the metrics, the
    check. `chain_cls` replaces the configuration's chain (the tests break
    it underneath); `overrides` as load_cell takes them."""
    cell, config, mix, e2e, per_layer = load_cell(name, root, overrides)
    loop = piece("loops", mix["loop"], root)
    if chain_cls is None:
        chain_cls = piece("chains", config["chain"], root).Chain
    span = Spans(traced)
    rig, pairs = traffic.render(config, mix, seed, device)
    chain = chain_cls(config, *rig, rectify=traffic.rectifies(mix), device=device)
    with tempfile.TemporaryDirectory(prefix="portbench-") as folder:
        files = traffic.write_files(pairs, mix, folder)
        run = traffic.Run(chain, span, config, mix, pairs, files, device)
        loop.prepare(run)
        traffic.sync(device)
        setup_s = time.perf_counter() - t_process
        run.sampler = traffic.Sampler(config["check_batches"], seed)
        cards = ([torch.device("cuda", i) for i in range(cell["chips"])]
                 if device.type == "cuda" else [])
        for card in cards:
            torch.cuda.reset_peak_memory_stats(card)
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                             else [])
            prof = profile(activities=acts)
            prof.__enter__()
        try:
            with chain.traced_layers(span) if traced else contextlib.nullcontext():
                window = loop.window(run, seconds)
            traffic.sync(device)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        peak = max((torch.cuda.max_memory_allocated(card) for card in cards), default=0)
        summary = summarize(prof, cell["chips"]) if prof is not None else None
        del prof
        samples = run.sampler.kept
        del chain, run
        readings = Readings(cell, config, mix, setup_s, window, peak, summary)
        metrics = read_metrics(per_layer if traced else e2e, readings, root)
        numbers = judge(config, mix, samples, pairs, files, rig, device, root)
    correct, checks = check.verdict(numbers, config["limits"])
    correct = correct and window.counts_ok and window.finished == window.issued
    result = {"correct": correct, "attempted": window.issued,
              "failed": window.issued - window.finished, "metrics": metrics,
              "device": device_info(device, peak, cell["chips"])}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result


def judge(config, mix, samples, pairs, files, rig, device, root: Path = ROOT) -> dict:
    """The worst numbers over the sampled pairs (reference on `device`); the
    first sampled pair of a mix with files is also judged against the
    reference's own decode of them."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
    res, maps = check.reference_rig(config, mix, *rig, device)
    ref = piece("reference", config["chain"], root)
    readings = [check.judge_pair(config, ref, s, pairs[s.index],
                                 None if files is None else files[s.index], res, maps, device,
                                 own_decode=i == 0)
                for i, s in enumerate(samples)]
    return check.worst(readings)


def device_info(device: torch.device, peak: int, count: int) -> dict:
    """The cards the run used: `peak` is the fullest one's."""
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak}
