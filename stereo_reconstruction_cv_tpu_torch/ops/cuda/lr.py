"""Left-right consistency check: plain PyTorch version and the CUDA kernel.

Plain versions of ``stereo_reconstruction_cv_tpu/ops/disparity.py``
(``lr_check``, ``lr_check_maps``) and the wrapper of ``csrc/lr_check.cu``,
which replaces the TPU kernel ``ops/pallas/lr_pallas.py:lr_check_maps_pallas``.

``lr_check_maps`` dispatches on the device of its inputs: CPU tensors take the
plain version, CUDA tensors launch the kernel (or raises). The kernel is one
launch with no scratch in device memory: each block holds its rows'
right-view winners in shared memory (``lr_rows_per_block``).
"""

from __future__ import annotations

import torch

from stereo_reconstruction_cv_tpu_torch import _build

_BIG = 1 << 29
# Shared memory of one block on Hopper: the most it may ask for (227 KB, after
# cudaFuncSetAttribute) and what it gets without asking.
SMEM_BLOCK_MAX = 232448
SMEM_DEFAULT = 48 * 1024

# Kernel launches by this module's wrapper: read by the tests, chip_smoke.py
# (which resets them) and utils/timing.graph_ms (which adds a graph's replays).
launches = {"lr_check": 0}


def lr_check_maps_plain(best: torch.Tensor, minS: torch.Tensor, disp: torch.Tensor,
                        num_disp: int, min_disp: int, max_diff: int) -> torch.Tensor:
    """OpenCV disp12MaxDiff from the (H, Wc) winner maps -> bool keep mask.

    The right-view winner of right column xr is the left pixel
    x = xr + min_disp + d whose own winner is d with the smallest winning cost
    (ties: smallest d), the gather form of OpenCV's scatter. A left pixel is
    dropped only if both the floor and the ceil of its disparity point at a
    right pixel with a winner that disagrees by more than max_diff."""
    H, Wc = best.shape
    D = num_disp
    x0 = min_disp + D
    W_full = x0 + Wc
    dev = best.device
    best = best.to(torch.int32)
    minS = minS.to(torch.int32)
    pad = (x0, D + min_disp)
    pad_best = torch.nn.functional.pad(best, pad, value=-1)
    pad_minS = torch.nn.functional.pad(minS, pad, value=_BIG)
    run_min = torch.full((H, W_full), _BIG, dtype=torch.int32, device=dev)
    run_arg = torch.zeros((H, W_full), dtype=torch.int32, device=dev)
    for d in range(D):
        s = min_disp + d
        b = pad_best[:, s:s + W_full]
        v = torch.where(b == d, pad_minS[:, s:s + W_full], _BIG)
        take = v < run_min
        run_min = torch.where(take, v, run_min)
        run_arg = torch.where(take, d, run_arg)
    has_partner = run_min < _BIG
    dispR = run_arg + min_disp

    def check(d_int):
        xr = torch.arange(Wc, device=dev)[None, :] + x0 - d_int
        xr_c = torch.clamp(xr, 0, W_full - 1).to(torch.int64)
        partner_valid = has_partner.gather(1, xr_c)
        dR = dispR.gather(1, xr_c)
        in_img = (xr >= 0) & (xr < W_full)
        return ~(in_img & partner_valid) | ((dR - d_int).abs() <= max_diff)

    d_floor = torch.floor(disp).to(torch.int32)
    d_ceil = torch.ceil(disp).to(torch.int32)
    return check(d_floor) | check(d_ceil)


def lr_check(S: torch.Tensor, disp: torch.Tensor, min_disp: int, max_diff: int) -> torch.Tensor:
    """Left-right consistency from the aggregated volume S (H, Wc, D)."""
    best = torch.argmin(S, dim=-1)
    minS = S.gather(-1, best[..., None])[..., 0]
    return lr_check_maps_plain(best, minS, disp, S.shape[-1], min_disp, max_diff)


def lr_rows_per_block(H: int, Wc: int, num_disp: int, min_disp: int) -> int:
    """Image rows one block of the kernel checks: enough for about 1024
    pixels where rows are short, within 48 KB of shared keys, one row where a
    row alone needs more. Raises ValueError where one row's keys
    (min_disp + num_disp + Wc int32) exceed what a block can hold."""
    Wf = min_disp + num_disp + Wc
    if 4 * Wf > SMEM_BLOCK_MAX:
        raise ValueError(
            f"lr_check: a row of min_disp + num_disp + Wc = {Wf} keys needs {4 * Wf} bytes "
            f"of shared memory; a block holds at most {SMEM_BLOCK_MAX} "
            f"({SMEM_BLOCK_MAX // 4} keys)")
    return max(1, min(H, -(-1024 // max(Wc, 1)), SMEM_DEFAULT // (4 * Wf)))


def lr_check_maps(best: torch.Tensor, minS: torch.Tensor, disp: torch.Tensor,
                  num_disp: int, min_disp: int, max_diff: int,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Keep mask (H, Wc) bool; kernel on CUDA tensors, plain on the CPU.

    With `out`, a bool (H, Wc) tensor on the inputs' device (contiguous on
    CUDA), the mask is ANDed into it in place and `out` is returned: the
    SGBM chain's ``valid &= keep`` without a separate op."""
    H, Wc = best.shape
    if minS.shape != (H, Wc) or disp.shape != (H, Wc):
        raise ValueError("best, minS and disp must share one (H, Wc) shape")
    if min_disp < 0 or max_diff < 0:
        raise ValueError(f"min_disp={min_disp} and max_diff={max_diff} must be >= 0")
    dev = best.device
    if out is not None and (out.shape != (H, Wc) or out.dtype != torch.bool or out.device != dev):
        raise ValueError(f"out must be a bool (H, Wc) = {(H, Wc)} tensor on {dev}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if dev.type == "cpu":
        keep = lr_check_maps_plain(best, minS, disp, num_disp, min_disp, max_diff)
        return keep if out is None else out.logical_and_(keep)
    _build.cuda_device("lr_check_maps", best, minS, disp)
    if out is not None and not out.is_contiguous():
        raise ValueError("lr_check_maps: out must be contiguous on CUDA")
    dq = 1
    while dq < num_disp + 1:
        dq *= 2
    # Packed keys minS*Dq + best must stay below the kernel's 0x7f7f7f7f fill;
    # minS <= 8 * (32767 + 65535 / 4) bounds every config check_sgm_bounds allows.
    if (8 * (0x7FFF + 0xFFFF // 4) + 1) * dq >= 0x7F7F7F7F:
        raise ValueError(f"num_disp={num_disp}: packed LR keys would overflow")
    rows = lr_rows_per_block(H, Wc, num_disp, min_disp)
    best = best.to(torch.int32).contiguous()
    minS = minS.to(torch.int32).contiguous()
    disp = disp.to(torch.float32).contiguous()
    keep = torch.empty((H, Wc), dtype=torch.bool, device=dev) if out is None else out
    _build.launch("srcv_lr_check", dev, best.data_ptr(), minS.data_ptr(), disp.data_ptr(),
                  keep.data_ptr(), H, Wc, num_disp, min_disp, max_diff, rows,
                  int(out is not None), counts=(launches, "lr_check"))
    return keep
