"""Compare two checkouts' kernels and main paths on one card, in turns.

    python -m stereo_reconstruction_cv_tpu_torch.tools.compare_smoke OTHER [--out DIR]

Runs ``python3 chip_smoke.py`` four times, alternating between OTHER (the
root of another checkout, for example the parent commit unpacked with
``git archive``) and this checkout: other, this, this, other. So both meet
the card in the same state and a drift of its clocks shows as a difference
between a tree's two runs. Each run's full log goes to DIR (default
``build/compare_smoke``); the numbers read from the logs are written to
DIR/summary.json and printed, with the card's name and power limit: kernel
times at 720p x 128 and 4K x 256, each sweep direction, the fused sweep
with each candidate direction, the S-volume route (``sgm_aggregate``, 5 and
8 paths, its peak memory, and ``sgm_sweep_sum``), the LR check at 720p,
the speckle kernels on each map (their label launches apart), each op-chain
case at each size and the SASS min counts, where the log has them; config
2 and config 3 s/pair, device busy time and idle share (config 3's peak
memory too); and each fused-sweep kernel instance's registers and spill
bytes from the tree's build log. Exit code 0 when all four runs exit 0.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

from stereo_reconstruction_cv_tpu_torch import _build

ROOT = Path(__file__).resolve().parents[2]

# (key, pattern): the first group of the first match is the number.
_PATTERNS = (
    ("cost_volume 720p ms", r"\[720p 720x1280x128 md=0\] cost_volume: equal; kernel ([\d.]+) ms"),
    ("cost_volume ragged ms", r"\[ragged 721x1283x96 md=5\] cost_volume: equal; kernel ([\d.]+) ms"),
    ("sgm_path_sweep x7 720p ms", r"\[720p 8-dir\] sgm_path_sweep x7: equal; kernel ([\d.]+) ms"),
    ("sgm_path_sweep x4 720p ms", r"\[720p 5-dir\] sgm_path_sweep x4: equal; kernel ([\d.]+) ms"),
    ("sgm_sweep_wta 720p 8-dir ms", r"\[720p 8-dir\] sgm_sweep_wta: equal .*?kernel ([\d.]+) ms"),
    ("sgm_sweep_wta 720p 5-dir ms", r"\[720p 5-dir\] sgm_sweep_wta: equal .*?kernel ([\d.]+) ms"),
    ("sgm_aggregate 720p 8-dir ms", r"\[720p 8-dir\] sgm_aggregate \(S volume\).*?kernels ([\d.]+) ms"),
    ("sgm_aggregate 720p 5-dir ms", r"\[720p 5-dir\] sgm_aggregate \(S volume\).*?kernels ([\d.]+) ms"),
    ("sgm_aggregate 720p 8-dir peak GiB",
     r"\[720p 8-dir\] sgm_aggregate \(S volume\).*?peak ([\d.]+) GiB"),
    ("sgm_aggregate 720p 5-dir peak GiB",
     r"\[720p 5-dir\] sgm_aggregate \(S volume\).*?peak ([\d.]+) GiB"),
    ("sgm_sweep_sum 720p 8-dir ms", r"\[720p 8-dir\] sgm_sweep_sum: equal; kernel ([\d.]+) ms"),
    ("sgm_sweep_sum 720p 5-dir ms", r"\[720p 5-dir\] sgm_sweep_sum: equal; kernel ([\d.]+) ms"),
    ("lr_check 720p 8-dir ms", r"\[720p 8-dir\] lr_check: equal; kernel ([\d.]+) ms"),
    ("lr_check 720p 5-dir ms", r"\[720p 5-dir\] lr_check: equal; kernel ([\d.]+) ms"),
    ("config 2 s/pair", r"sgbm_disparity 720p x128 8-dir \(device speckle\).*?warm median ([\d.e-]+) s"),
    ("config 2 device busy ms",
     r"profile 720p sgbm_disparity x128 8-dir \(device speckle\): wall [\d.]+ ms, device busy ([\d.]+) ms"),
    ("config 2 idle share",
     r"profile 720p sgbm_disparity x128 8-dir \(device speckle\): .*?idle share ([-\d.]+)"),
    ("config 3 s/pair", r"4K device chain 3840x2160 x256 5-dir.*?warm median ([\d.e-]+) s"),
    ("config 3 peak GiB", r"4K device chain 3840x2160 x256 5-dir.*?peak ([\d.]+) GiB"),
    ("config 3 device busy ms", r"profile 4K device chain [^:]*: wall [\d.]+ ms, device busy ([\d.]+) ms"),
    ("config 3 idle share", r"profile 4K device chain [^:]*: .*?idle share ([-\d.]+)"),
    ("4K pair -> PLY s/pair", r"4K e2e 3840x2160 x256 5-dir.*?warm median ([\d.e-]+) s"),
    ("build s", r"built CUDA kernels in ([\d.]+) s"),
)


def parse(log: str) -> dict:
    """The numbers of one chip_smoke.py log (keys missing where the log
    lacks them)."""
    out = {}
    for key, pat in _PATTERNS:
        m = re.search(pat, log)
        if m:
            out[key] = float(m.group(1))
    m = re.search(r"4K disparity breakdown \(ms\): (\{.*\})", log)
    if m:
        for k, v in json.loads(m.group(1)).items():
            out[f"4K {k} ms"] = v
    for m in re.finditer(r"\[(\S+) \d+x\d+x\d+\] sgm_path_sweep per direction: (\{.*\})", log):
        for d, v in json.loads(m.group(2)).items():
            out[f"sgm_path_sweep {m.group(1)} ({d}) ms"] = v["ms"]
    for m in re.finditer(r"\[(\S+) \d+x\d+x\d+ \d-dir\] fused direction candidates.*?: (\{.*\})",
                         log):
        for d, v in json.loads(m.group(2)).items():
            for k in ("sweeps_ms", "sweep_wta_ms", "sum_ms"):
                out[f"fused {m.group(1)} ({d}) {k[:-3]} ms"] = v[k]
    for m in re.finditer(r"\[([^\]]+?) \(\d+, \d+\)\] speckle_labels: equal to the plain "
                         r"fixpoint; kernel ([\d.]+) ms", log):
        out[f"speckle_labels {m.group(1)} ms"] = float(m.group(2))
    for m in re.finditer(r"\[([^\]]+)\] speckle_keep: equal .*?; kernel ([\d.]+) ms", log):
        out[f"speckle_keep {m.group(1)} ms"] = float(m.group(2))
    for m in re.finditer(r"\[([^\]]+)\] speckle_labels launches \(ms, profiler\): (\{.*\})", log):
        for k, v in json.loads(m.group(2)).items():
            out[f"speckle_labels {m.group(1)} {k} ms"] = v
    for m in re.finditer(r"\[op_chain \((\d+), (\d+)\) torch\.(\w+) ([\w+]+)\] equal; kernel "
                         r"([\d.]+) us", log):
        out[f"op_chain {m.group(1)}x{m.group(2)} {m.group(3)} {m.group(4)} us"] = float(m.group(5))
    m = re.search(r"^op_chain SASS, add\+min at W = 512: .*?(\{.*\})$", log, re.M)
    if m:
        for k, v in json.loads(m.group(1)).items():
            out[f"op_chain SASS {k} mins"] = v["min_instructions"] if isinstance(v, dict) else v
    m = re.search(r'^(\{"kernels": .*\})$', log, re.M)
    if m:
        for k in json.loads(m.group(1))["kernels"]:
            out[f"kernels line {k['name']} ms"] = k["ms"]
    m = (re.search(r"^nvidia-smi: (.*)$", log, re.M)
         or re.search(r'^(.*)\n\{"ok": true', log, re.M))
    if m:
        out["card"] = m.group(1).strip()
    return out


def ptxas(tree: Path) -> dict:
    """Registers and spill bytes of each fused-sweep instance (sweep_wta,
    sweep_sum), from ptxas's report in the newest kernel build log under
    `tree`'s build/ (the build its chip_smoke.py run just made)."""
    logs = sorted((tree / "build").glob("libsrcv_kernels-*.log"), key=lambda p: p.stat().st_mtime)
    out = {}
    for entry, r in (_build.ptxas_report(logs[-1].read_text()).items() if logs else ()):
        if "sweep_wta_kernel" in entry or "sweep_sum_kernel" in entry:
            name = _build.kernel_instance(entry)
            out[f"ptxas {name} registers"] = r["registers"]
            out[f"ptxas {name} spill bytes"] = r["spill_stores"] + r["spill_loads"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout (its chip_smoke.py is run there)")
    ap.add_argument("--out", default=str(ROOT / "build" / "compare_smoke"))
    args = ap.parse_args(argv)
    trees = {"other": Path(args.other).resolve(), "this": ROOT}
    for name, path in trees.items():
        if not (path / "chip_smoke.py").exists():
            print(f"FAIL: no chip_smoke.py in {path} ({name})")
            return 2
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    runs, rc_all = [], 0
    for i, name in enumerate(("other", "this", "this", "other")):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=trees[name],
                              capture_output=True, text=True)
        wall = time.perf_counter() - t0
        log = proc.stdout + "\n--- stderr ---\n" + proc.stderr
        (out_dir / f"run{i}_{name}.log").write_text(log)
        rc_all |= proc.returncode
        runs.append({"run": i, "tree": name, "rc": proc.returncode, "wall_s": wall,
                     **parse(proc.stdout), **ptxas(trees[name])})
        print(f"run {i} ({name}): rc {proc.returncode}, {wall:.1f} s", flush=True)
    summary = {"trees": {k: str(v) for k, v in trees.items()}, "runs": runs}
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0 if rc_all == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
