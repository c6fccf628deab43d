"""Left-right consistency check: plain PyTorch version and the CUDA kernel.

Plain versions of ``stereo_reconstruction_cv_tpu/ops/disparity.py``
(``lr_check``, ``lr_check_maps``) and the wrapper of ``csrc/lr_check.cu``,
which replaces the TPU kernel ``ops/pallas/lr_pallas.py:lr_check_maps_pallas``.

``lr_check_maps`` dispatches on the device of its inputs: CPU tensors take the
plain version, CUDA tensors launch the kernel (or raises).
"""

from __future__ import annotations

import torch

from stereo_reconstruction_cv_tpu_torch import _build

_BIG = 1 << 29

# Kernel launches by this module's wrapper (read and reset by chip_smoke.py).
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


def lr_check_maps(best: torch.Tensor, minS: torch.Tensor, disp: torch.Tensor,
                  num_disp: int, min_disp: int, max_diff: int) -> torch.Tensor:
    """Keep mask (H, Wc) bool; kernel on CUDA tensors, plain on the CPU."""
    H, Wc = best.shape
    if minS.shape != (H, Wc) or disp.shape != (H, Wc):
        raise ValueError("best, minS and disp must share one (H, Wc) shape")
    if min_disp < 0 or max_diff < 0:
        raise ValueError(f"min_disp={min_disp} and max_diff={max_diff} must be >= 0")
    dev = best.device
    if dev.type == "cpu":
        return lr_check_maps_plain(best, minS, disp, num_disp, min_disp, max_diff)
    if dev.type != "cuda" or minS.device != dev or disp.device != dev:
        raise ValueError("lr_check_maps: inputs must all lie on one CUDA device")
    dq = 1
    while dq < num_disp + 1:
        dq *= 2
    # Packed keys minS*Dq + best must stay below the kernel's 0x7f7f7f7f fill;
    # minS <= 8 * (32767 + 65535 / 4) bounds every config check_sgm_bounds allows.
    if (8 * (0x7FFF + 0xFFFF // 4) + 1) * dq >= 0x7F7F7F7F:
        raise ValueError(f"num_disp={num_disp}: packed LR keys would overflow")
    best = best.to(torch.int32).contiguous()
    minS = minS.to(torch.int32).contiguous()
    disp = disp.to(torch.float32).contiguous()
    pk = torch.empty((H, min_disp + num_disp + Wc), dtype=torch.int32, device=dev)
    keep = torch.empty((H, Wc), dtype=torch.bool, device=dev)
    lib = _build.kernels_library()
    with torch.cuda.device(dev):
        err = lib.srcv_lr_check(
            best.data_ptr(), minS.data_ptr(), disp.data_ptr(), pk.data_ptr(),
            keep.data_ptr(), H, Wc, num_disp, min_disp, max_diff,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "lr_check")
    launches["lr_check"] += 1
    return keep
