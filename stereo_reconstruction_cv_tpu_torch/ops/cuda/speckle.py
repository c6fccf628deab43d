"""Speckle filter on the device: plain PyTorch versions and the CUDA kernels.

Plain versions of ``stereo_reconstruction_cv_tpu/ops/disparity.py``
(``_seg_min_flood``, the XLA branch of ``speckle_filter`` with its
``max_rounds`` loop and bincount size test) and the wrappers of
``csrc/speckle.cu``, whose two kernels replace:

- ``speckle_labels``: the TPU flood kernels of
  ``ops/pallas/speckle_pallas.py`` (``flood_round_flagged``,
  ``flood_round_pallas``) iterated to their fixpoint. The kernel computes the
  fixpoint directly, by union-find, in three launches and no host sync;
- ``speckle_keep``: ``disparity.py:_component_keep_sort`` (the sorted size
  test the TPU needed for want of fast scatters), as a histogram of the
  component roots in two aggregated passes over count cells that the
  wrapper keeps per (device, H*W) and that the kernels leave zero.

The label map is what the flood converges to: every valid pixel gets the
smallest linear index of its 4-connected component (neighbours joined where
both are valid and |d(p) - d(q)| <= max_diff in f32), every invalid pixel the
sink label H*W. Components of at most ``max_size`` pixels are dropped.

``speckle_filter`` dispatches on the device of its inputs: CPU tensors take
the plain version, CUDA tensors launch the kernels (or raise). The plain
flood stops after ``max_rounds`` rounds, as the reference's does; the kernels
are always exact (cv2.filterSpeckles), so the two differ only on maps whose
flood has not converged by then. The kernels read ``disp`` and ``valid``
through their row stride, so a column slice of a wider map is not copied.

``reduced_connectivity`` is the plain mirror of the edges the label kernel
unites (csrc/speckle.cu): the tests hold that flooding over them reaches the
same fixpoint as flooding over every edge.
"""

from __future__ import annotations

import torch

from stereo_reconstruction_cv_tpu_torch import _build

# Kernel launches by this module's wrappers: read by the tests, chip_smoke.py
# (which resets them) and utils/timing.graph_ms (which adds a graph's replays).
launches = {"speckle_labels": 0, "speckle_keep": 0}

MAX_ROUNDS = 64
# speckle_keep_cuda's count cells by (device, pixels): see count_cells.
_cells: dict = {}
TILE = 32  # the label kernel's square tile (csrc/speckle.cu TW, TH)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def connectivity(disp: torch.Tensor, valid: torch.Tensor, max_diff: float):
    """(ch, cv) bool (H, W): pixel joined to its left / upper neighbour
    (first column / row False)."""
    disp = disp.to(torch.float32)
    ch = torch.zeros_like(valid)
    cv = torch.zeros_like(valid)
    ch[:, 1:] = ((disp[:, 1:] - disp[:, :-1]).abs() <= max_diff) & valid[:, 1:] & valid[:, :-1]
    cv[1:, :] = ((disp[1:, :] - disp[:-1, :]).abs() <= max_diff) & valid[1:, :] & valid[:-1, :]
    return ch, cv


def initial_labels(valid: torch.Tensor) -> torch.Tensor:
    """Linear index for valid pixels, the sink H*W for invalid ones (int32)."""
    H, W = valid.shape
    lab = torch.arange(H * W, dtype=torch.int32, device=valid.device).reshape(H, W)
    return torch.where(valid, lab, torch.full_like(lab, H * W))


def _shift(x: torch.Tensor, s: int, axis: int, before: bool, fill) -> torch.Tensor:
    """x[i - s] (before) or x[i + s] along `axis`, `fill` where it leaves."""
    n = x.shape[axis]
    out = torch.full_like(x, fill)
    if s < n:
        if before:
            out.narrow(axis, s, n - s).copy_(x.narrow(axis, 0, n - s))
        else:
            out.narrow(axis, 0, n - s).copy_(x.narrow(axis, s, n - s))
    return out


def seg_min_flood(lab: torch.Tensor, conn: torch.Tensor, axis: int, big: int) -> torch.Tensor:
    """Two-sided min-flood of labels along `axis` within connectivity segments,
    by log-doubling (the reference's _seg_min_flood, level for level).
    conn[i]: element i joined to its predecessor along the axis."""
    n = lab.shape[axis]
    bigv = torch.full_like(lab, big)
    C = conn
    s = 1
    while s < n:
        lab = torch.minimum(lab, torch.where(C, _shift(lab, s, axis, True, 0), bigv))
        C_next = _shift(C, s, axis, False, False)  # span (i .. i+s) connected
        lab = torch.minimum(lab, torch.where(C_next, _shift(lab, s, axis, False, 0), bigv))
        C = C & _shift(C, s, axis, True, False)
        s *= 2
    return lab


def flood_round(lab: torch.Tensor, ch: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """One round: row flood, then column flood."""
    big = lab.numel()
    return seg_min_flood(seg_min_flood(lab, ch, 1, big), cv, 0, big)


def speckle_labels_plain(disp: torch.Tensor, valid: torch.Tensor, max_diff: float,
                         max_rounds: int = MAX_ROUNDS):
    """Flood rounds until one changes nothing or `max_rounds` ran, as the
    reference's while_loop -> (labels int32, converged bool)."""
    ch, cv = connectivity(disp, valid, max_diff)
    lab = initial_labels(valid)
    for _ in range(max_rounds):
        new = flood_round(lab, ch, cv)
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            return lab, True
    return lab, False


def reduced_connectivity(ch: torch.Tensor, cv: torch.Tensor):
    """The edges the label kernel unites, as (ch, cv) bool (H, W) masks.

    A pixel joined to its left neighbour inside a tile is kept (the kernel's
    runs). A vertical edge (p, p - W) is dropped where p - 1 lies in p's
    tile column and p, p - 1, p - 1 - W, p - W form a joined square: the
    square's other three edges connect the two pixels. A horizontal edge
    across a tile's left border is dropped where the square above it closes
    the same way (its two vertical edges and the crossing one row up), except
    on a tile's top row. Each dropped edge is implied by a chain that ends in
    a kept one, so the components stay the same."""
    H, W = ch.shape
    dev = ch.device
    inner_x = (torch.arange(W, device=dev) % TILE != 0)[None, :]
    inner_y = (torch.arange(H, device=dev) % TILE != 0)[:, None]
    sq_v = torch.zeros_like(cv)
    sq_v[1:, 1:] = ch[1:, 1:] & ch[:-1, 1:] & cv[1:, :-1]
    sq_h = torch.zeros_like(ch)
    sq_h[1:, 1:] = cv[1:, 1:] & cv[1:, :-1] & ch[:-1, 1:]
    return ch & ~(sq_h & ~inner_x & inner_y), cv & ~(sq_v & inner_x)


def speckle_keep_plain(labels: torch.Tensor, valid: torch.Tensor, max_size: int) -> torch.Tensor:
    """valid & (size of the pixel's component > max_size), bincount form."""
    sizes = torch.bincount(labels.reshape(-1).to(torch.int64), minlength=labels.numel() + 1)
    return valid & (sizes[labels.to(torch.int64)] > max_size)


def speckle_filter_plain(disp: torch.Tensor, valid: torch.Tensor, max_size: int,
                         max_diff: float) -> torch.Tensor:
    """The reference's speckle_filter (XLA branch): keep mask (H, W) bool."""
    labels, _ = speckle_labels_plain(disp, valid, max_diff)
    return speckle_keep_plain(labels, valid, max_size)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def _check_maps(disp: torch.Tensor, valid: torch.Tensor) -> None:
    if disp.dim() != 2 or valid.shape != disp.shape:
        raise ValueError(f"disp {tuple(disp.shape)} and valid {tuple(valid.shape)} "
                         "must share one (H, W) shape")
    if valid.dtype != torch.bool:
        raise ValueError(f"valid must be a bool tensor, got {valid.dtype}")
    if disp.numel() >= 2**31 - 1:
        raise ValueError(f"{disp.numel()} pixels: int32 labels hold at most 2^31 - 2")


def _rows(t: torch.Tensor):
    """(t, its row stride in elements) where t's elements within a row are
    adjacent, as in a column slice of a wider map; else a contiguous copy."""
    if t.shape[1] > 1 and t.stride(1) != 1:
        t = t.contiguous()
    return t, t.stride(0)


def speckle_labels_cuda(disp: torch.Tensor, valid: torch.Tensor, max_diff: float) -> torch.Tensor:
    """Kernel: the flood's fixpoint label map (H, W) int32, exactly."""
    _check_maps(disp, valid)
    dev = _build.cuda_device("speckle_labels", disp, valid)
    H, W = disp.shape
    disp, ds = _rows(disp.to(torch.float32))
    valid, vs = _rows(valid)
    labels = torch.empty((H, W), dtype=torch.int32, device=dev)
    _build.launch("srcv_speckle_labels", dev, disp.data_ptr(), valid.data_ptr(), labels.data_ptr(),
                  H, W, ds, vs, float(max_diff), counts=(launches, "speckle_labels"))
    return labels


def count_cells(dev: torch.device, n: int) -> torch.Tensor:
    """The keep kernels' count cells for maps of n pixels on `dev`: (n,) int64,
    zero between calls (the kernels return them to zero). Made once per
    (device, n) and kept, so a CUDA graph that captured a call stays valid;
    calls that share them must run in order on one stream."""
    key = (dev, n)
    cells = _cells.get(key)
    if cells is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"speckle_keep_cuda: no count cells yet for {n} pixels on {dev}; call it "
                "once outside CUDA graph capture first")
        cells = torch.zeros(n, dtype=torch.int64, device=dev)
        _cells[key] = cells
    return cells


def speckle_keep_cuda(labels: torch.Tensor, valid: torch.Tensor, max_size: int) -> torch.Tensor:
    """Kernel: valid & (component size > max_size) from a fixpoint label map."""
    if labels.dtype != torch.int32:
        raise ValueError(f"labels must be int32, got {labels.dtype}")
    _check_maps(labels, valid)
    dev = _build.cuda_device("speckle_keep", labels, valid)
    H, W = labels.shape
    labels = labels.contiguous()
    valid, vs = _rows(valid)
    cells = count_cells(dev, H * W)
    keep = torch.empty((H, W), dtype=torch.bool, device=dev)
    try:
        _build.launch("srcv_speckle_keep", dev, labels.data_ptr(), valid.data_ptr(),
                      cells.data_ptr(), keep.data_ptr(), H, W, vs, int(max_size),
                      counts=(launches, "speckle_keep"))
    except RuntimeError:
        del _cells[(dev, H * W)]  # a pass may not have run: the cells are no longer zero
        raise
    return keep


def speckle_filter(disp: torch.Tensor, valid: torch.Tensor, max_size: int = 100,
                   max_diff: float = 32.0) -> torch.Tensor:
    """Keep mask (H, W) bool: the kernels on CUDA tensors, plain on the CPU."""
    _check_maps(disp, valid)
    if max_size < 0:
        raise ValueError(f"max_size={max_size} must be >= 0")
    if disp.device.type == "cpu" and valid.device.type == "cpu":
        return speckle_filter_plain(disp, valid, max_size, max_diff)
    labels = speckle_labels_cuda(disp, valid, max_diff)
    return speckle_keep_cuda(labels, valid, max_size)
