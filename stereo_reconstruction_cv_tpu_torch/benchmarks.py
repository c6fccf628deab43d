"""Benchmark suite of the port: the five BASELINE configurations, one JSON line per metric.

    python -m stereo_reconstruction_cv_tpu_torch.cli bench [CONFIGS ...]

The port of ``stereo_reconstruction_cv_tpu/benchmarks.py``, with its metric
names and fields:

  1. 720p BT cost + 11x11 box + WTA, 64 disparities   [sad_wta_720p_64disp]
  2. 720p SGBM, 8 paths + LR check, 128 disparities    [sgbm_disparity_720p_128disp]
  3. live calibration, then rectify + SGBM + reproject at 4K x 256
     [e2e_4k_pair_to_cloud, e2e_4k_pair_to_cloud_alpha1,
      sgbm_disparity_4k_128disp, sgbm_disparity_4k_128disp_5dir]
  4. learned match + triangulation at 960x536         [sparse_match_triangulate]
  5. 8 distinct 4K JPEG pairs: decode -> H2D -> SGBM -> masked point sum,
     pipelined by the prefetch loader                  [streaming_8pair_4k]

Config 2, the headline, runs first and is printed again last
(``_DEFAULT_ORDER``). Every line also carries ``backend`` ("torch-cuda" or
"torch-cpu"), the card's name and power limit, the torch and CUDA versions,
``data: "rendered"`` with the scene it names, the frame size, and the
timing: a synchronised wall clock around each run, the first run apart
(``first_s``) and the median, min and max of the warm runs (seconds a pair;
``value`` is taken from the median). ``vs_baseline`` (cv2 on the host) is
null.

Where it differs from the reference, on purpose:
- the data is rendered from seeds (``utils/synth.py``, ``textured_pair``),
  not read from the reference's dataset, which is not in the repository;
  config 3 calibrates on 44 rendered 4K boards;
- config 1's WTA is block matching's (``wta_volume`` with no delta
  volume, as ``sgm_wta`` runs it at ``num_directions=0``: the kernel over
  the int16 volume on the card, which tests uniqueness in int32 arithmetic, as the plain version
  on the volume widened to int32 does): the reference's XLA
  ``wta_disparity`` on the int16 volume wraps S * 100 and marks most pixels
  invalid at uniqueness 0 (ROADMAP C, reference fault 9);
- config 5's window holds every pair's decode and host -> device copy, which
  it counts (``n_decodes``, ``n_h2d_events``), and the frames are JPEG files
  written by PIL and decoded by the named ``decoder`` (reference fault 4);
- a config that fails prints its error line, the others still run, and
  ``main`` returns 1; the reference's time caps and environment knobs are
  not ported.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch import native
from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig
from stereo_reconstruction_cv_tpu_torch.io.image import save_image
from stereo_reconstruction_cv_tpu_torch.models import xfeat as XF
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
from stereo_reconstruction_cv_tpu_torch.ops import matching as MT
from stereo_reconstruction_cv_tpu_torch.ops import rectify as RC
from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK
from stereo_reconstruction_cv_tpu_torch.ops.cuda.cost import cost_volume, xsobel_clip
from stereo_reconstruction_cv_tpu_torch.parallel.prefetch import PrefetchLoader
from stereo_reconstruction_cv_tpu_torch.pipeline import stages
from stereo_reconstruction_cv_tpu_torch.tools.probe_sweep import textured_pair
from stereo_reconstruction_cv_tpu_torch.utils import synth
from stereo_reconstruction_cv_tpu_torch.utils.timing import card

HEADLINE = "sgbm_disparity_720p_128disp"
# Config 4's working size (W, H; multiples of 8 for the net) and keypoints a frame.
CONFIG4_SIZE, CONFIG4_MAXK = (960, 536), 1024
# Config 5's JPEG quality (PIL's encoder) and the least PSNR of a decoded
# frame against the rendered one.
JPEG_QUALITY, JPEG_MIN_PSNR_DB = 95, 35.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, runs: int, dev: torch.device):
    """fn() once cold and `runs` times warm, each between synchronisations:
    ({first_s, median_s, min_s, max_s, runs} of the warm runs, the last
    result)."""
    walls, out = [], None
    for _ in range(1 + runs):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    warm = walls[1:] or walls
    return {"first_s": walls[0], "median_s": statistics.median(warm), "min_s": min(warm),
            "max_s": max(warm), "runs": runs}, out


def _telemetry(dev: torch.device) -> dict:
    """The card's state just after a config's runs: its SM clock (MHz) and
    power draw (W) over NVML's last sample period (1/6 to 1 s), its
    temperature, and the caching allocator's reserved memory and cumulative
    count of retried allocations (each retry frees cached blocks with a
    device synchronisation). None where NVML cannot be read."""
    out = {"sm_clock_mhz": None, "power_draw_w": None, "temperature_c": None}
    try:
        out = {"sm_clock_mhz": torch.cuda.clock_rate(dev),
               "power_draw_w": torch.cuda.power_draw(dev) / 1e3,
               "temperature_c": torch.cuda.temperature(dev)}
    except (ImportError, RuntimeError):  # no pynvml, or NVML refused
        pass
    stats = torch.cuda.memory_stats(dev)
    return {**out, "reserved_gib": torch.cuda.memory_reserved(dev) / 2**30,
            "alloc_retries_total": stats.get("num_alloc_retries", 0)}


def _fields(dev: torch.device, size, scene: str) -> dict:
    """The fields every line carries: backend, card, versions, data, size;
    on the card also its telemetry (_telemetry)."""
    name, limit, extra = "cpu", None, {}
    if dev.type == "cuda":
        name, _, limit = card().rpartition(", ")
        extra = _telemetry(dev)
    return {"backend": f"torch-{dev.type}", "card": name, "power_limit": limit,
            "torch": torch.__version__, "cuda": torch.version.cuda, "data": "rendered",
            "scene": scene, "size": list(size), **extra}


def _textured(size, seed: int, shift: int, dev: torch.device):
    """textured_pair (left[y, x] == right[y, x - shift]) on `dev`."""
    W, H = size
    left, right = textured_pair(np.random.default_rng(seed), H, W, shift)
    return torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)


def scaled(size, scale: float):
    """(W, H) times scale, each a multiple of 8 (at least 8)."""
    return tuple(max(8, int(round(v * scale / 8.0)) * 8) for v in size)


# ---------------------------------------------------------------------------
# Config 1: 720p BT cost + box + WTA, 64 disparities
# ---------------------------------------------------------------------------

def sad_wta_step(left: torch.Tensor, right: torch.Tensor, num_disp: int = 64,
                 block: int = 11, cap: int = 63):
    """Config 1's step (reference benchmarks.py:133-142): the clipped Sobel and
    raw planes (no border pinning), the cost volume over the columns x >=
    num_disp, and block matching's WTA at min_disp 0 and uniqueness 0 on it
    (wta_volume with no delta volume) -> (disp f32, valid) of those columns."""
    C = cost_volume(xsobel_clip(left, cap), xsobel_clip(right, cap), left.to(torch.int32),
                    right.to(torch.int32), num_disp, 0, block)
    return SK.wta_volume(C, (), 0, 0)[:2]


def bench_config1(device="cuda", size=(1280, 720), iters=8):
    dev = stages.resolve_device(device)
    D, block = 64, 11
    shift = max(1, round(30 * size[0] / 1280))
    left, right = _textured(size, synth.SEED + 1, shift, dev)

    def step():
        disp, valid = sad_wta_step(left, right, D, block)
        return float(torch.where(valid, disp, torch.zeros_like(disp)).sum().item())

    t, _ = _timed(step, iters, dev)
    planes = (xsobel_clip(left), xsobel_clip(right), left.to(torch.int32), right.to(torch.int32))
    t_cost, C = _timed(lambda: cost_volume(*planes, D, 0, block), iters, dev)
    t_wta, _ = _timed(lambda: SK.wta_volume(C, (), 0, 0), iters, dev)
    mpix = size[0] * size[1] / 1e6
    return {
        "metric": "sad_wta_720p_64disp",
        "value": mpix / t["median_s"],
        "unit": "MPix/s",
        "vs_baseline": None,
        **_fields(dev, size, f"textured_pair(seed {synth.SEED + 1}), shift {shift} px"),
        **t,
        "cost_median_s": t_cost["median_s"],
        "wta_median_s": t_wta["median_s"],
    }


# ---------------------------------------------------------------------------
# Config 2 (headline): 720p SGBM, 8 paths + LR check, 128 disparities
# ---------------------------------------------------------------------------

def bench_config2(device="cuda", size=(1280, 720), iters=5):
    dev = stages.resolve_device(device)
    shift = max(1, round(30 * size[0] / 1280))
    left, right = _textured(size, synth.SEED + 1, shift, dev)
    cfg = SGBMConfig(num_disparities=128, num_directions=8)
    t, _ = _timed(lambda: float(DP.sgbm_disparity(left, right, cfg)[0].sum().item()), iters, dev)
    mpix = size[0] * size[1] / 1e6
    return {
        "metric": HEADLINE,
        "value": mpix / t["median_s"],
        "unit": "MPix/s",
        "dirs": 8,
        "vs_baseline": None,
        **_fields(dev, size, f"textured_pair(seed {synth.SEED + 1}), shift {shift} px"),
        **t,
    }


# ---------------------------------------------------------------------------
# Config 3: live calibration, then rectify + SGBM + reprojection at 4K x 256
# ---------------------------------------------------------------------------

def _live_calibration(dev: torch.device, size):
    """Config 3's rig set-up (reference benchmarks.py:230-250): the
    calibration set rendered at `size`, detected and calibrated
    (calibrate_camera on every view), first and warm -> (K, warm seconds,
    first seconds, mean_error)."""
    W, H = size
    cs = synth.calibration_set(dev, H=H, W=W)
    runs = [synth.calibrate_set(cs, lambda: _sync(dev), stereo=False) for _ in range(2)]
    for run in runs:
        if run["missed"]:
            raise RuntimeError(f"calibration: no board found in views (camera, pose) {run['missed']}")
    first, warm = (r["detect_s"] + r["lm_s"] for r in runs)
    mono = runs[1]["mono"]
    return mono.K.cpu().numpy(), warm, first, float(mono.mean_error)


def bench_config3(device="cuda", size=(3840, 2160), iters=3):
    dev = stages.resolve_device(device)
    W, H = size
    shift = max(1, round(48 * W / 3840))
    left, right = _textured(size, synth.SEED + 2, shift, dev)
    K, calib_s, calib_first_s, calib_err = _live_calibration(dev, size)
    # 5 paths, cv2's default MODE_SGBM, as the reference notebook runs it.
    cfg = SGBMConfig(num_disparities=256, num_directions=5)
    core = cfg.with_(speckle_window_size=0)

    def make_e2e(alpha):
        """The chain for the rig at this alpha; its maps, rectification and
        Q are rig constants, made once, as the reference closes over them."""
        Kt, res = synth.rectified_rig(size, alpha, K)
        maps = [RC.rectify_map(Kt, None, R, P, (W, H), device=dev)
                for R, P in ((res.R1, res.P1), (res.R2, res.P2))]
        Q = res.Q.to(torch.float32)  # on the host: the reprojection takes its values

        def e2e():
            rl = RC.remap_bilinear(left, maps[0])
            rr = RC.remap_bilinear(right, maps[1])
            d, v = DP.sgbm_disparity_auto(rl, rr, core)
            keep = DP._speckle(d, v, cfg)
            pts = G.reproject_image_to_3d(d, Q)
            return float(torch.where(keep[..., None], pts, torch.zeros_like(pts)).sum().item())
        return e2e

    scene = f"textured_pair(seed {synth.SEED + 2}), shift {shift} px"
    t0, _ = _timed(make_e2e(0.0), iters, dev)
    t0.update(_fields(dev, size, scene))
    t1, _ = _timed(make_e2e(1.0), iters, dev)
    t1.update(_fields(dev, size, scene))
    cfg128 = cfg.with_(num_disparities=128, speckle_window_size=0)
    rows = {}
    for dirs in (5, 8):
        c = cfg128.with_(num_directions=dirs)
        rows[dirs], _ = _timed(
            lambda: float(DP.sgbm_disparity_auto(left, right, c)[0].sum().item()), iters, dev)
        rows[dirs].update(_fields(dev, size, scene))
    mpix = W * H / 1e6
    calib = {"calib_s": calib_s, "calib_first_s": calib_first_s, "calib_mean_reproj_px": calib_err,
             "calib_boards": f"{2 * synth.CALIB_POSES} rendered views ({synth.CALIB_POSES} poses x 2 "
                             "cameras)"}
    return [
        {"metric": "sgbm_disparity_4k_128disp", "value": mpix / rows[8]["median_s"],
         "unit": "MPix/s", "dirs": 8, "mode": "MODE_HH (full 8-path)", "vs_baseline": None,
         **rows[8]},
        {"metric": "sgbm_disparity_4k_128disp_5dir", "value": mpix / rows[5]["median_s"],
         "unit": "MPix/s", "dirs": 5, "mode": "MODE_SGBM (5-dir, cv2/reference default)",
         "vs_baseline": None, **rows[5]},
        {"metric": "e2e_4k_pair_to_cloud", "value": t0["median_s"], "unit": "s/pair", "dirs": 5,
         "fps": 1.0 / t0["median_s"], "mpix_per_s": mpix / t0["median_s"], **calib,
         "vs_baseline": None, **t0},
        {"metric": "e2e_4k_pair_to_cloud_alpha1", "value": t1["median_s"], "unit": "s/pair",
         "dirs": 5, "fps": 1.0 / t1["median_s"], "vs_baseline": None, **t1},
    ]


# ---------------------------------------------------------------------------
# Config 4: learned match + batched triangulation at 960x536
# ---------------------------------------------------------------------------

def bench_config4(device="cuda", size=CONFIG4_SIZE, iters=5, pairs=3):
    """Config 4 (reference benchmarks.py:405) on `pairs` rendered pairs:
    each pair's median, then their mean, as the reference averages its
    pairs (the line's median_s is that mean)."""
    dev = stages.resolve_device(device)
    W, H = size
    model = stages._xfeat_model(None, dev)
    K, res = synth.rectified_rig(size)
    P1, P2 = res.P1.to(dev, torch.float32), res.P2.to(dev, torch.float32)
    T = np.array([-synth.BASELINE_M, 0.0, 0.0])
    times = []
    for k in range(pairs):
        left, right = synth.render_pair(K.numpy(), np.eye(3), T, H, W, seed=synth.SEED + k,
                                        device=dev)

        def step():
            f1, f2 = XF.detect_pair(model, left, right, CONFIG4_MAXK)
            m = MT.match_learned(f1.descriptors, f2.descriptors)
            a, b, ok = MT.gather_correspondences(f1.keypoints, f2.keypoints, m)
            pts = G.triangulate_points(P1, P2, a, b)
            return torch.where(ok[:, None], pts, torch.zeros_like(pts)).sum(0)
        times.append(_timed(step, iters, dev)[0])
    dt = statistics.mean(t["median_s"] for t in times)
    return {
        "metric": "sparse_match_triangulate",
        "value": 1e3 * dt,
        "unit": "ms/pair",
        "pairs_per_s": 1.0 / dt,
        "vs_baseline": None,
        **_fields(dev, size, f"render_pair seeds {synth.SEED}-{synth.SEED + pairs - 1}, "
                             "rectified rig, shipped v4 weights"),
        "first_s": times[0]["first_s"],
        "median_s": dt,
        "min_s": min(t["min_s"] for t in times),
        "max_s": max(t["max_s"] for t in times),
        "runs": iters * pairs,
    }


# ---------------------------------------------------------------------------
# Config 5: 8 distinct 4K JPEG pairs, decode -> H2D -> SGBM -> masked point sum
# ---------------------------------------------------------------------------

def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def bench_config5(device="cuda", size=(3840, 2160), decoder="nvjpeg", n_pairs=8, windows=3):
    """Config 5 (reference benchmarks.py:495): two rendered base pairs and
    gain variants of them (1 + 0.03 (i // 2)), n_pairs distinct pairs,
    written as JPEG files before the window. Each window runs a fresh
    PrefetchLoader (a pair a batch, 2 batches ahead, 4 decode threads)
    over all of them: every pair is decoded, copied to the
    device, run through SGBM (128 disparities, 8 paths, LR check, no
    speckle) and reduced to the masked point sum; `windows` windows, the
    line's value from the median one."""
    native.check_decoder(decoder)
    dev = stages.resolve_device(device)
    W, H = size
    K, res = synth.rectified_rig(size)
    Q = res.Q.to(torch.float32)  # on the host: the reprojection takes its values
    cfg = SGBMConfig(num_disparities=128, num_directions=8, speckle_window_size=0)
    T = np.array([-synth.BASELINE_M, 0.0, 0.0])
    bases = [np.stack([v.cpu().numpy() for v in synth.render_pair(
        K.numpy(), np.eye(3), T, H, W, seed=synth.SEED + k, device=dev)]) for k in (0, 1)]

    def make_pair(i):
        b = bases[i % 2]
        if i < 2:
            return b
        gain = 1.0 + 0.03 * (i // 2)
        return np.clip(b.astype(np.float32) * gain, 0, 255).astype(np.uint8)

    def pair_sum(left, right):
        d, v = DP.sgbm_disparity_auto(left, right, cfg)
        return torch.where(v[..., None], G.reproject_image_to_3d(d, Q), 0.0).sum()

    frames = [make_pair(i) for i in range(n_pairs)]
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i, pair in enumerate(frames):
            row = tuple(os.path.join(td, f"pair{i}_{side}.jpg") for side in "lr")
            for img, path in zip(pair, row):
                save_image(path, img, quality=JPEG_QUALITY)
            paths.append(row)
        # Decoded against rendered, and one pair's serial decode time.
        psnr = min(_psnr(native.load_image(p, True, decoder), img)
                   for pair, row in zip(frames, paths) for img, p in zip(pair, row))
        t_dec, _ = _timed(lambda: [native.load_image(p, True, decoder) for p in paths[0]], 3, dev)

        def window(items):
            with PrefetchLoader(items, decoder=decoder, device=dev) as loader:
                sums = [pair_sum(a, b) for l, r in loader for a, b in zip(l, r)]
                total = float(torch.stack(sums).sum().item())
            return total, loader

        window(paths[:2])  # warm: decoders, pinned and device allocators
        runs = []
        for _ in range(windows):
            _sync(dev)
            t0 = time.perf_counter()
            total, loader = window(paths)
            _sync(dev)
            runs.append((time.perf_counter() - t0, total, loader.images_decoded,
                         loader.h2d_copies))
    fields = _fields(dev, size, f"render_pair seeds {synth.SEED}-{synth.SEED + 1} (rectified "
                                "rig) and gain variants")
    dt_pipe, total, images, copies = sorted(runs)[len(runs) // 2]
    if len({(r[2], r[3]) for r in runs}) != 1:
        raise RuntimeError(f"config 5: the windows' counts differ: {runs}")

    # Compute only: two pairs resident on the device.
    staged = [torch.from_numpy(f).to(dev) for f in frames[:2]]
    t_dev, _ = _timed(lambda: float(torch.stack([pair_sum(*staged[i % 2])
                                                 for i in range(n_pairs)]).sum().item()), 1, dev)
    # The link: one pair from pinned memory.
    h2d_MBps = None
    if dev.type == "cuda":
        pinned = torch.from_numpy(frames[0]).pin_memory()
        t_copy, _ = _timed(lambda: pinned.to(dev, non_blocking=True), 5, dev)
        h2d_MBps = pinned.numel() / t_copy["median_s"] / 1e6
    mpix = W * H / 1e6
    walls = [r[0] / n_pairs for r in runs]
    return {
        "metric": "streaming_8pair_4k",
        "value": mpix / (dt_pipe / n_pairs),
        "unit": "MPix/s",
        "dirs": 8,
        "pairs_per_s": n_pairs / dt_pipe,
        "n_pairs": n_pairs,
        "n_decodes": images // 2,
        "n_images_decoded": images,
        "n_h2d_events": copies,
        "compute_only_mpix_per_s": mpix / (t_dev["median_s"] / n_pairs),
        "h2d_MBps": h2d_MBps,
        "decoder": decoder,
        "encoder": f"PIL quality {JPEG_QUALITY}",
        "decode_psnr_db_min": psnr,
        "decode_pair_s": t_dec["median_s"],
        "masked_point_sum": total,
        "host_cpus": os.cpu_count(),
        "note": ("value = decode + H2D + SGBM + masked point sum of every pair inside the "
                 "window, pipelined by the prefetch loader; compute_only = resident pairs"),
        "vs_baseline": None,
        **fields,
        "first_s": None,
        "median_s": dt_pipe / n_pairs,
        "min_s": min(walls),
        "max_s": max(walls),
        "runs": windows,
    }


_CONFIGS = {1: bench_config1, 2: bench_config2, 3: bench_config3, 4: bench_config4,
            5: bench_config5}
# The headline (config 2) runs and prints first, and is printed again last.
_DEFAULT_ORDER = (2, 1, 4, 3, 5)
# The reference's frame size of each config, (W, H).
_SIZES = {1: (1280, 720), 2: (1280, 720), 3: (3840, 2160), 4: CONFIG4_SIZE, 5: (3840, 2160)}


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(configs=None, device="cuda", decoder="nvjpeg", scale: float = 1.0, around=None) -> int:
    """Run `configs` (default _DEFAULT_ORDER) on `device`, frames scaled by
    `scale`; config 5 decodes with `decoder`. Prints one JSON line per
    metric, the headline again last. A config that raises prints
    {"metric": "configN", "error": ...} (its traceback on stderr) and the
    rest still run. `around(c)`, when given, is a context manager entered
    around config c (chip_smoke.py counts its launches there). Returns 1 if
    any config failed, else 0."""
    configs = list(_DEFAULT_ORDER) if not configs else [int(c) for c in configs]
    headline, failed = None, False
    for c in configs:
        kwargs = {"device": device, "size": scaled(_SIZES[c], scale)}
        if c == 5:
            kwargs["decoder"] = decoder
        try:
            if around is None:
                out = _CONFIGS[c](**kwargs)
            else:
                with around(c):
                    out = _CONFIGS[c](**kwargs)
        except Exception as e:  # one config failing must not hide the rest
            traceback.print_exc(file=sys.stderr)
            _emit({"metric": f"config{c}", "error": f"{type(e).__name__}: {e}"[:300],
                   "backend": f"torch-{torch.device(device).type}"})
            failed = True
            continue
        for obj in out if isinstance(out, list) else [out]:
            _emit(obj)
            if obj["metric"] == HEADLINE:
                headline = obj
    if headline is not None and len(configs) > 1:
        _emit(headline)
    return 1 if failed else 0
