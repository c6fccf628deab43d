"""The 16-bit op-chain probe: plain PyTorch version and the CUDA kernel.

Port of ``tools/micro_i16.py``'s ``_chain_kernel`` (run by its ``run``),
which asks whether 16-bit add / min / roll chains run faster than 32-bit
ones. ``op_chain`` applies REPS steps to an (H, W) array, each step

    r = roll(x, 1) along W  (if "roll" in ops; out[i] = x[i - 1], wrapping)
    r = r + 1               (if "add" in ops; integers wrap)
    x = min(x, r)           (if "min" in ops; else x = r)

in the array's own dtype (float32, int32, int16, uint16 or bfloat16). The
kernel is ``csrc/op_chain.cu``, with its REPS steps written out as the
reference writes them and 16-bit elements two to a register; a CPU tensor
takes the plain version.
"""

from __future__ import annotations

from typing import Sequence

import torch

from stereo_reconstruction_cv_tpu_torch import _build

REPS = 96  # steps in the chain (the kernel unrolls exactly this many)
DTYPES = {torch.float32: 0, torch.int32: 1, torch.int16: 2, torch.uint16: 3,
          torch.bfloat16: 4}
OPS = {"roll": 1, "add": 2, "min": 4}
WIDTHS = (32, 64, 128, 256, 512)  # W = 32 lanes x 1..16 elements in registers

# Kernel launches by this module's wrapper: read by the tests, chip_smoke.py
# (which resets them) and utils/timing.graph_ms (which adds a graph's replays).
launches = {"op_chain": 0}


def ops_bits(ops: Sequence[str]) -> int:
    """The kernel's bit mask of `ops`, a set of "roll", "add", "min"."""
    unknown = set(ops) - set(OPS)
    if unknown:
        raise ValueError(f"unknown ops {sorted(unknown)}; choose from {sorted(OPS)}")
    return sum(OPS[o] for o in set(ops))


def op_chain_plain(x: torch.Tensor, ops: Sequence[str], reps: int = REPS) -> torch.Tensor:
    """`reps` steps of the chain in plain PyTorch. uint16, which PyTorch adds
    and compares only through wider types, runs in int32 masked to 16 bits."""
    wide = x.dtype == torch.uint16
    y = x.to(torch.int32) if wide else x
    one = torch.ones((), dtype=y.dtype, device=y.device)
    for _ in range(reps):
        r = torch.roll(y, 1, -1) if "roll" in ops else y
        if "add" in ops:
            r = r + one
            if wide:
                r = r & 0xFFFF
        y = torch.minimum(y, r) if "min" in ops else r
    return y.to(torch.uint16) if wide else y


def op_chain(x: torch.Tensor, ops: Sequence[str]) -> torch.Tensor:
    """REPS steps of the chain on an (H, W) array, W in WIDTHS: the kernel on
    a CUDA tensor, the plain version on the CPU."""
    bits = ops_bits(ops)
    if x.dtype not in DTYPES:
        raise ValueError(f"dtype {x.dtype} not in {list(DTYPES)}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] not in WIDTHS:
        raise ValueError(f"x must be (H, W) with H >= 1 and W in {WIDTHS}, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return op_chain_plain(x, ops)
    dev = _build.cuda_device("op_chain", x)
    x = x.contiguous()
    out = torch.empty_like(x)
    H, W = x.shape
    _build.launch("srcv_op_chain", dev, x.data_ptr(), out.data_ptr(), H, W, DTYPES[x.dtype], bits,
                  counts=(launches, "op_chain"))
    return out
