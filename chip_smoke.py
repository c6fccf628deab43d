#!/usr/bin/env python3
"""Drive the PyTorch port's dense path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases:
  1. device    the card's name and power limit, torch / CUDA / nvcc versions
  2. build     nvcc over stereo_reconstruction_cv_tpu_torch/csrc, g++ over
               native/speckle.cc, timed
  3. kernels   each CUDA kernel against its plain PyTorch version on the card,
               at 1280x720 x 128 (5 and 8 directions) and at a ragged
               721x1283 x 96 with min_disp 5: integer maps, masks and the f32
               disparity must be EQUAL; CUDA-event times of both
  4. 720p      the 720p SGBM call (8 paths, LR check, host speckle) and the
               CLI's chain disparity -> reconstruct -> PLY, on a synthetic pair
               with a known shift
  5. 4K        3840x2160 x 256, 5 paths: stereo_rectify -> rectify_remap ->
               compute_disparity_map -> reproject -> PLY, the rig of the
               reference's 4K benchmark; every kernel's launch count must rise;
               s/pair (cold, then median of warm runs), stages, peak memory,
               device idle share under torch.profiler
  6. 4K plain  on that frame's rectified pair, each kernel against its plain
               version at D = 256 (cost in row bands with the box halo, each
               path direction alone and as the accumulated group, the fused
               sweep + WTA in row bands, the LR check), all EQUAL; the plain
               chain's disparity map equals the main path's; kernel times
Launch counts are zeroed just before phase 4 and read right after phase 5's
last run, so they count the main path's launches only. Prints one JSON line
of kernel results before the last line, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, without that line, when a
phase fails or no CUDA device is present. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

SEED = 0
# Reference calibration anchor of the 4K rig and its 140 mm baseline.
K_4K = np.array([[2253.71, 0.0, 1929.69], [0.0, 2244.72, 1057.63], [0.0, 0.0, 1.0]])
BASELINE_M = 0.140

KERNELS = {
    "cost_volume": ("stereo_reconstruction_cv_tpu_torch/csrc/cost_volume.cu",
                    "stereo_reconstruction_cv_tpu/ops/pallas/cost_pallas.py:222"),
    "sgm_path_sweep": ("stereo_reconstruction_cv_tpu_torch/csrc/sgm.cu",
                       "stereo_reconstruction_cv_tpu/ops/pallas/sgm_pallas.py:563"),
    "sgm_sweep_wta": ("stereo_reconstruction_cv_tpu_torch/csrc/sgm.cu",
                      "stereo_reconstruction_cv_tpu/ops/pallas/sgm_pallas.py:505"),
    "lr_check": ("stereo_reconstruction_cv_tpu_torch/csrc/lr_check.cu",
                 "stereo_reconstruction_cv_tpu/ops/pallas/lr_pallas.py:130"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def textured_pair(rng, H: int, W: int, shift: int):
    """uint8 (H, W) pair with left[y, x] == right[y, x - shift]: smoothed
    noise (3x3 box) so bilinear resampling keeps it matchable."""
    n = rng.uniform(0, 255, size=(H + 2, W + shift + 2)).astype(np.float32)
    base = sum(n[i:i + H, j:j + W + shift] for i in range(3) for j in range(3)) / 9.0
    base = np.clip((base - base.mean()) * 3.0 + 128.0, 0, 255).astype(np.uint8)
    return base[:, :W].copy(), base[:, shift:].copy()


def cuda_ms(torch, fn, reps: int) -> float:
    """Median of `reps` CUDA-event timings of fn() (after the caller warmed it)."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(torch, a, b, fa=None, rows: int = 64) -> float:
    """max |fa(a) - b| over two tensors of one shape (bools: 1 if any differ),
    taken in chunks of `rows` along the first axis so that full-size volumes
    need no full-size float64 copies. fa defaults to the identity."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dtype == torch.bool or b.dtype == torch.bool:
        return float(bool((a != b).any().item()))
    err = 0.0
    for i in range(0, a.shape[0], rows):
        ai, bi = a[i:i + rows], b[i:i + rows]
        if fa is not None:
            ai = fa(ai)
        if ai.numel():
            err = max(err, float((ai.double() - bi.double()).abs().max().item()))
    return err


def within_shift(disp, valid_cols_from: int, expect: float):
    """(share of valid non-margin pixels within 1 px of expect, valid share)."""
    d = disp[:, valid_cols_from:]
    v = d > 0
    n = int(v.sum().item())
    if n == 0:
        return 0.0, 0.0
    good = int(((d - expect).abs() <= 1.0)[v].sum().item())
    return good / n, n / d.numel()


def profile_idle(torch, label: str, fn) -> None:
    """One fn() under torch.profiler: logs its wall time, the device's busy
    time (the union of its kernel, copy and set intervals) and the idle share
    1 - busy / wall, with the largest device items."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.name.startswith("Activity Buffer")
    )
    if not spans:
        log(f"profile {label}: wall {wall_us / 1e3:.3f} ms; device busy not measured "
            "(the profiler recorded no device activity)")
        return
    busy, end = 0.0, float("-inf")
    items: dict = {}
    for s, e, name in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
        t, n = items.get(name, (0.0, 0))
        items[name] = (t + e - s, n + 1)
    log(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
        f"idle share {1.0 - busy / wall_us:.4f}")
    for name, (t, n) in sorted(items.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"    {t / 1e3:9.3f} ms  x{n:<4d} {name[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        log("FAIL device: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("FAIL device: torch.cuda.is_available() is False; this check needs an NVIDIA GPU")
        return 1
    try:
        from stereo_reconstruction_cv_tpu_torch import _build
        from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
        from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
        from stereo_reconstruction_cv_tpu_torch.ops import rectify as RC
        from stereo_reconstruction_cv_tpu_torch.ops.cuda import cost as CK
        from stereo_reconstruction_cv_tpu_torch.ops.cuda import lr as LK
        from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK
        from stereo_reconstruction_cv_tpu_torch.pipeline import stages
    except ImportError as e:
        log(f"FAIL import: {e} (run from the root of a checkout of the repository)")
        return 1

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []
    results = {name: {"max_abs_err": 0.0} for name in KERNELS}
    # The default SGBM parameters (cv2.StereoSGBM's set in the reference).
    defaults = DP.SGBMConfig()
    p1, p2 = defaults.p1, defaults.p2
    ur, maxd = defaults.uniqueness_ratio, defaults.disp12_max_diff

    def phase(name):
        def wrap(fn):
            t0 = time.perf_counter()
            log(f"== phase {name}")
            try:
                fn()
                log(f"== phase {name}: ok ({time.perf_counter() - t0:.2f} s)")
            except Exception:
                traceback.print_exc()
                sys.stdout.flush()
                failures.append(name)
                log(f"== phase {name}: FAILED")
            return fn
        return wrap

    # ------------------------------------------------------------ 1. device
    @phase("1 device")
    def _():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        log(f"nvidia-smi: {smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else smi.stderr.strip()}")
        log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
            f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}  "
            f"capability {torch.cuda.get_device_capability(0)}")
        nv = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                            text=True, timeout=60)
        log("nvcc: " + nv.stdout.strip().splitlines()[-1])

    # ------------------------------------------------------------- 2. build
    @phase("2 build")
    def _():
        t0 = time.perf_counter()
        _build.kernels_library()
        t1 = time.perf_counter()
        _build.speckle_library()
        t2 = time.perf_counter()
        log(f"built CUDA kernels in {t1 - t0:.1f} s, host speckle in {t2 - t1:.1f} s")
        for logf in sorted(_build.BUILD_DIR.glob("libsrcv_kernels-*.log")):
            for line in logf.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    log("  ptxas " + line.strip())

    if failures:
        return 1

    # ----------------------------------------------------------- 3. kernels
    def planes_for(rng, H, W, D, min_disp):
        left, right = textured_pair(rng, H, W, min(D // 2, W // 4))
        return DP.cost_planes(torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev), 63)

    def note(name, err):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max |err| {err})")

    @phase("3 kernels vs plain")
    def _():
        rng = np.random.default_rng(SEED)
        cases = [("720p", 720, 1280, 128, 0, (5, 8)), ("ragged", 721, 1283, 96, 5, (8, 5))]
        for label, H, W, D, md, dirs in cases:
            planes = planes_for(rng, H, W, D, md)
            C = CK.cost_volume(*planes, D, md, 11)
            Cp = CK.cost_volume_plain(*planes, D, md, 11)
            note("cost_volume", max_err(torch, C, Cp))
            del Cp
            t_k = cuda_ms(torch, lambda: CK.cost_volume(*planes, D, md, 11), 5)
            t_p = cuda_ms(torch, lambda: CK.cost_volume_plain(*planes, D, md, 11), 3)
            log(f"[{label} {H}x{W}x{D} md={md}] cost_volume: equal; kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
            if label == "720p":
                results["cost_volume"].update(ms=t_k, plain_ms=t_p)
            for nd in dirs:
                groups = [g for g in SK.delta_groups(nd) if g]

                def sweeps_plain():
                    return [sum(SK.path_delta_plain(C, dx, dy, p1, p2) for dx, dy in g)
                            for g in groups]

                vols, vols_p = SK.path_deltas_cuda(C, nd, p1, p2), sweeps_plain()
                if len(vols) != len(vols_p):
                    raise AssertionError(f"{len(vols)} delta volumes, expected {len(vols_p)}")
                for v, vp in zip(vols, vols_p):
                    note("sgm_path_sweep", max_err(torch, v, vp, fa=SK.u16))
                partial = sum(vols_p)
                got = SK.sweep_wta_cuda(C, vols, nd, p1, p2, ur, md)
                ref = SK.sweep_wta_plain(C, partial, nd, p1, p2, ur, md)
                note("sgm_sweep_wta", max(max_err(torch, a, b) for a, b in zip(got, ref)))
                # The dispatching chain the main path calls gives the same maps.
                chain = SK.sgm_wta(C, p1, p2, nd, ur, md)
                note("sgm_sweep_wta", max(max_err(torch, a, b) for a, b in zip(chain, ref)))
                disp, valid, best, minS = got
                keep = LK.lr_check_maps(best, minS, disp, D, md, maxd)
                keep_p = LK.lr_check_maps_plain(best, minS, disp, D, md, maxd)
                note("lr_check", max_err(torch, keep, keep_p))
                t_sk = cuda_ms(torch, lambda: SK.path_deltas_cuda(C, nd, p1, p2), 5)
                t_sp = cuda_ms(torch, sweeps_plain, 3)
                t_wk = cuda_ms(torch, lambda: SK.sweep_wta_cuda(C, vols, nd, p1, p2, ur, md), 5)
                t_wp = cuda_ms(torch, lambda: SK.sweep_wta_plain(C, partial, nd, p1, p2, ur, md), 3)
                t_lk = cuda_ms(torch, lambda: LK.lr_check_maps(best, minS, disp, D, md, maxd), 5)
                t_lp = cuda_ms(torch, lambda: LK.lr_check_maps_plain(best, minS, disp, D, md, maxd), 3)
                log(f"[{label} {nd}-dir] sgm_path_sweep x{nd - 1}: equal; kernel {t_sk:.3f} ms, plain {t_sp:.3f} ms")
                log(f"[{label} {nd}-dir] sgm_sweep_wta: equal (disp, valid, best, minS); "
                    f"kernel {t_wk:.3f} ms, plain {t_wp:.3f} ms; valid share {valid.float().mean().item():.4f}")
                log(f"[{label} {nd}-dir] lr_check: equal; kernel {t_lk:.3f} ms, plain {t_lp:.3f} ms; "
                    f"keep share {keep.float().mean().item():.4f}")
                if label == "720p" and nd == 8:
                    results["sgm_path_sweep"].update(ms=t_sk, plain_ms=t_sp)
                    results["sgm_sweep_wta"].update(ms=t_wk, plain_ms=t_wp)
                    results["lr_check"].update(ms=t_lk, plain_ms=t_lp)
                del vols, vols_p, partial
            del C
            torch.cuda.empty_cache()

    # The main path (phases 4 and 5): counts start at zero here and are read
    # right after phase 5's last run, before phase 6 calls kernels directly.
    for mod in (CK, SK, LK):
        for k in mod.launches:
            mod.launches[k] = 0

    def counts():
        return {**CK.launches, **SK.launches, **LK.launches}

    def rig(W, H, alpha):
        s = W / 3840.0
        K = K_4K.copy()
        K[:2] *= s
        Kt = torch.tensor(K, dtype=torch.float64)
        res = RC.stereo_rectify(Kt, None, Kt, None, (W, H), torch.eye(3, dtype=torch.float64),
                                torch.tensor([-BASELINE_M, 0.0, 0.0], dtype=torch.float64),
                                alpha=alpha)
        return Kt, res

    # -------------------------------------------------------------- 4. 720p
    @phase("4 main path 720p")
    def _():
        rng = np.random.default_rng(SEED + 1)
        H, W, shift = 720, 1280, 30
        left, right = textured_pair(rng, H, W, shift)
        l, r = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
        cfg = DP.SGBMConfig(num_disparities=128, num_directions=8, speckle_backend="exact")
        before = counts()
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            disp, valid = DP.sgbm_disparity(l, r, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        warm = statistics.median(walls[1:])
        share, vshare = within_shift(torch.where(valid, disp, torch.zeros_like(disp)), 128, shift)
        log(f"sgbm_disparity 720p x128 8-dir: s/pair first {walls[0]}, warm {walls[1:]} "
            f"(warm median {warm} s, {H * W / 1e6 / warm} MPix/s); valid {vshare:.4f}; "
            f"within 1 px of {shift}: {share:.4f}")
        if share < 0.95 or vshare < 0.5:
            raise AssertionError("720p disparity does not recover the known shift")
        profile_idle(torch, "720p sgbm_disparity x128 8-dir (host speckle)",
                     lambda: DP.sgbm_disparity(l, r, cfg))
        profile_idle(torch, "720p sgbm_disparity x128 8-dir (no speckle)",
                     lambda: DP.sgbm_disparity(l, r, cfg.with_(speckle_window_size=0)))
        Kt, res = rig(W, H, 0.0)
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "cloud.ply")
            t0 = time.perf_counter()
            dmap = stages.disparity(left, right, ndisp=128, device="cuda")
            pts = stages.reconstruct(dmap, res.Q, device="cuda")
            n = stages.export_point_cloud(out, pts, dmap, device="cuda")
            wall = time.perf_counter() - t0
            n_file = check_ply(out)
        n_mask = int(G.valid_point_mask(pts, dmap).sum().item())
        share, vshare = within_shift(dmap, 128, shift)
        log(f"CLI chain 720p x128 5-dir: {wall:.4f} s, {n} points (file {n_file}, mask {n_mask}); "
            f"within 1 px of {shift}: {share:.4f}")
        if not (n == n_file == n_mask) or n < 0.5 * H * (W - 128) or share < 0.95:
            raise AssertionError("720p point cloud is wrong")
        after = counts()
        missing = [k for k in after if after[k] <= before[k]]
        if missing:
            raise AssertionError(f"kernels not launched by the 720p path: {missing}")

    # ---------------------------------------------------------------- 5. 4K
    main_counts = {}
    frame = {}  # phase 5's rectified pair and disparity map, for phase 6
    H4, W4, D4 = 2160, 3840, 256

    @phase("5 main path 4K")
    def _():
        rng = np.random.default_rng(SEED + 2)
        shift = 48
        left, right = textured_pair(rng, H4, W4, shift)
        Kt, res = rig(W4, H4, 0.0)
        expect = shift * float(res.P1[0, 0] / Kt[0, 0])
        before = counts()

        def run(out_path, stamps=None):
            def mark(name):
                if stamps is not None:
                    torch.cuda.synchronize()
                    stamps.append((name, time.perf_counter()))
            mark("start")
            l = torch.from_numpy(left).to(dev)
            r = torch.from_numpy(right).to(dev)
            rl = RC.rectify_remap(l, Kt, None, res.R1, res.P1)
            rr = RC.rectify_remap(r, Kt, None, res.R2, res.P2)
            mark("rectify")
            dmap = DP.compute_disparity_map(rl, rr, D4, 0)
            mark("disparity")
            pts = stages.reconstruct(dmap, res.Q, device="cuda")
            mark("reproject")
            n = stages.export_point_cloud(out_path, pts, dmap, device="cuda")
            mark("export")
            frame.update(rl=rl, rr=rr, dmap=dmap)
            return pts, n

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "cloud_4k.ply")
            walls = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pts, n = run(out)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            n_file = check_ply(out)
            stamps = []
            run(out, stamps)
            profile_idle(torch, "4K pair -> PLY x256 5-dir", lambda: run(out))
        peak = torch.cuda.max_memory_allocated()
        main_counts.update(counts())
        steps = {b[0]: b[1] - a[1] for a, b in zip(stamps, stamps[1:])}
        warm = statistics.median(walls[1:])
        dmap = frame["dmap"]
        share, vshare = within_shift(dmap, D4, expect)
        log(f"4K e2e {W4}x{H4} x{D4} 5-dir: s/pair first (cold) {walls[0]}, warm {walls[1:]} "
            f"(warm median {warm} s, {H4 * W4 / 1e6 / warm} MPix/s); {n} points (file {n_file})")
        log("4K stages (s, synchronised): " + json.dumps(steps))
        log(f"4K disparity: valid non-margin share {vshare:.4f}; within 1 px of "
            f"{shift} x P1[0,0]/K[0,0] = {expect:.3f}: {share:.4f}")
        log(f"4K main path device memory: peak {peak / 2**30:.3f} GiB "
            f"(allocated before the runs {base / 2**30:.3f} GiB)")
        if share < 0.95 or vshare < 0.5:
            raise AssertionError("4K disparity does not recover the known shift")
        if n != n_file or n < 0.5 * H4 * (W4 - D4) or not bool(torch.isfinite(pts[dmap > 0]).all()):
            raise AssertionError("4K point cloud is wrong")
        missing = [k for k in main_counts if main_counts[k] <= before[k]]
        if missing:
            raise AssertionError(f"kernels not launched by the 4K path: {missing}")
        log("launch counts in the 4K runs: "
            + json.dumps({k: main_counts[k] - before[k] for k in main_counts}))

    # ------------------------------------------------------ 6. 4K vs plain
    @phase("6 4K kernels vs plain")
    def _():
        if "dmap" not in frame:
            raise AssertionError("phase 5 left no 4K frame to check")
        cfg = DP.SGBMConfig(num_disparities=D4, num_directions=5)  # compute_disparity_map's
        nd, D, md = cfg.num_directions, cfg.num_disparities, cfg.min_disparity
        planes = DP.cost_planes(frame["rl"], frame["rr"], cfg.pre_filter_cap)
        C = CK.cost_volume(*planes, D, md, cfg.block_size)
        H = C.shape[0]
        # Cost: full-width row bands, each with the box's halo rows.
        band, r = 120, cfg.block_size // 2
        err = 0.0
        for y0 in range(0, H, band):
            y1 = min(H, y0 + band)
            h0, h1 = max(0, y0 - r), min(H, y1 + r)
            ref = CK.cost_volume_plain(*(p[h0:h1] for p in planes), D, md, cfg.block_size)
            err = max(err, max_err(torch, C[y0:y1], ref[y0 - h0:y1 - h0]))
        note("cost_volume", err)
        log(f"[4K {H}x{W4}x{D}] cost_volume: equal in {len(range(0, H, band))} row bands")
        # Path sweeps: each direction alone, then the accumulated group.
        C32 = C.to(torch.int32)
        partial = torch.zeros_like(C32)
        one = torch.empty_like(C)
        for dx, dy in (d for g in SK.delta_groups(nd) for d in g):
            SK.path_sweep_cuda(C, one, dx, dy, p1, p2, accumulate=False)
            ref = SK.path_delta_plain(C32, dx, dy, p1, p2)
            note("sgm_path_sweep", max_err(torch, one, ref, fa=SK.u16))
            partial += ref
            del ref
        del one
        vols = SK.path_deltas_cuda(C, nd, p1, p2)
        note("sgm_path_sweep", max_err(torch, vols[0], partial, fa=SK.u16))
        log(f"[4K {nd}-dir] sgm_path_sweep: each direction and the accumulated group equal")
        # Fused last sweep + WTA: its path is horizontal, so row bands are exact.
        maps = SK.sweep_wta_cuda(C, vols, nd, p1, p2, ur, md)
        parts = [SK.sweep_wta_plain(C32[y0:y0 + 540], partial[y0:y0 + 540], nd, p1, p2, ur, md)
                 for y0 in range(0, H, 540)]
        maps_p = [torch.cat([p[k] for p in parts]) for k in range(4)]
        del parts, C32, partial
        note("sgm_sweep_wta", max(max_err(torch, a, b) for a, b in zip(maps, maps_p)))
        log(f"[4K {nd}-dir] sgm_sweep_wta: equal (disp, valid, best, minS); "
            f"valid share {maps[1].float().mean().item():.4f}")
        disp, valid, best, minS = maps
        keep = LK.lr_check_maps(best, minS, disp, D, md, cfg.disp12_max_diff)
        keep_p = LK.lr_check_maps_plain(best, minS, disp, D, md, cfg.disp12_max_diff)
        note("lr_check", max_err(torch, keep, keep_p))
        log(f"[4K] lr_check: equal; keep share {keep.float().mean().item():.4f}")
        # The plain chain, finished as compute_disparity_map finishes it,
        # gives the main path's map.
        x0 = md + D
        disp_full = torch.nn.functional.pad(maps_p[0], (x0, 0), value=float(md - 1))
        valid_full = torch.nn.functional.pad(maps_p[1] & keep_p, (x0, 0), value=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        valid_full = DP.filter_speckles_host(disp_full, valid_full, cfg.speckle_window_size,
                                             float(cfg.speckle_range))
        torch.cuda.synchronize()
        speckle_ms = 1e3 * (time.perf_counter() - t0)
        d = torch.where(valid_full, disp_full, torch.full_like(disp_full, float(md) - 1.0))
        dmap_p = torch.where(d > 0, d, torch.zeros_like(d))
        if max_err(torch, frame["dmap"], dmap_p) != 0:
            raise AssertionError("the main path's 4K disparity map differs from the plain chain's")
        log("[4K] disparity map of the main path equals the plain chain's")
        # Each kernel alone at this shape, and the host speckle pass.
        kernel_ms = {
            "cost_volume": cuda_ms(torch, lambda: CK.cost_volume(*planes, D, md, cfg.block_size), 3),
            f"sgm_path_sweep x{nd - 1}": cuda_ms(torch, lambda: SK.path_deltas_cuda(C, nd, p1, p2), 3),
            "sgm_sweep_wta": cuda_ms(torch, lambda: SK.sweep_wta_cuda(C, vols, nd, p1, p2, ur, md), 3),
            "lr_check": cuda_ms(torch, lambda: LK.lr_check_maps(best, minS, disp, D, md,
                                                                cfg.disp12_max_diff), 3),
            "host speckle (wall, copies included)": speckle_ms,
        }
        log("4K disparity breakdown (ms): " + json.dumps(kernel_ms))

    if failures:
        log(f"FAILED phases: {failures}")
        return 1
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_counts[name], "max_abs_err": results[name]["max_abs_err"],
            "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def check_ply(path: str) -> int:
    """Point count of a binary PLY, after checking its size and finiteness."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode().strip()
            header.append(line)
            if line == "end_header":
                break
        body = f.read()
    n = next(int(h.split()[-1]) for h in header if h.startswith("element vertex"))
    rec = 15 if any("uchar red" in h for h in header) else 12
    if len(body) != n * rec:
        raise AssertionError(f"PLY body holds {len(body)} bytes, expected {n * rec}")
    if rec == 12 and not np.isfinite(np.frombuffer(body, "<f4")).all():
        raise AssertionError("PLY holds non-finite coordinates")
    return n


if __name__ == "__main__":
    sys.exit(main())
