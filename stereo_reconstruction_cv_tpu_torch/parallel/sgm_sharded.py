"""Row-sharded, batch-parallel SGBM over a device mesh (after ``stereo_reconstruction_cv_tpu/parallel/sgm_sharded.py``).

Pairs are split two ways over a ``parallel.mesh.Mesh``:

  batch -> 'data'  (independent pairs, no communication)
  rows  -> 'space' (neighbouring shards exchange rows or DP carries)

Horizontal paths are row-local. Vertical and diagonal paths carry state
across rows, and two modes handle it:

- halo warm-start (``sharded_sgbm_disparity``, the default): each shard takes
  ``halo`` rows from each interior neighbour, runs ``ops.disparity.
  sgbm_disparity`` on the extended block and crops it. At a true image edge
  it takes no rows, so its scans start where the single-device ones do. (The
  reference's docstring says so too, but its ``ppermute`` hands the edge
  shards ``halo`` zero rows: reference fault 12, ROADMAP.md C.)
- exact (``exact=True``, ``sharded_sgbm_disparity_exact``): the same maps as
  the single-device ``sgbm_disparity``, bit for bit, on any mesh, from the
  same stages of ``ops.disparity`` around sweeps of its own: ``validate``;
  ``sgbm_cost`` on each shard's rows plus the Sobel and box halo
  (``ops.disparity.cost_halo``) of each interior neighbour; the vertical and diagonal
  sweeps hand their last row's DP carry to the next shard along the path
  (``sgm_path_sweep``'s carry, ``ops/cuda/sgm.py:path_sweep_cuda``); the last
  direction, fused with WTA, is a horizontal one (``EXACT_FUSED``), so it
  needs no carry; then ``sgbm_post`` (LR check, margin). The handoffs go out
  in wavefront order: direction k of shard s is issued with direction k + 1
  of the shard before it, so with a device per shard every device has a
  sweep to run while its carry travels.

The speckle filter runs sharded too (``sharded_speckle_filter``): each
shard labels its rows (``speckle_labels``) and counts its pieces; the pieces
that meet across a shard boundary are joined by the same edge rule on the
boundary rows, and their summed sizes go back through each shard's labels.
The result equals the single-device filter exactly; counts are int64 (the
reference's 7-bit count field is reference fault 3). With SGBM it runs right
of ``ops.disparity.margin``, as the single-device filter does.

Block matching (``num_directions=0``) has no sharded mode: both modes
refuse it (``ValueError``), and ``ops.disparity.sgbm_disparity`` runs it.

Inputs are (B, H, W) uint8 tensors, placed with
``mesh.batch_row_sharding`` (or already ``Sharded`` that way); outputs are
``Sharded`` the same way (``mesh.gather`` assembles them). Each shard's
frames run through the port's kernels where its device is a CUDA device and
through their plain versions on the CPU.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import speckle as SPK
from stereo_reconstruction_cv_tpu_torch.parallel.mesh import (
    Mesh,
    Sharded,
    batch_row_sharding,
    from_next,
    from_prev,
    place,
)
from stereo_reconstruction_cv_tpu_torch.utils.profiling import span

# The direction fused with WTA in exact mode: a horizontal one, row-local.
# S is a sum of integers, so the maps do not depend on which runs last.
EXACT_FUSED = (-1, 0)


def _on_mesh(mesh: Mesh, x) -> Sharded:
    if isinstance(x, Sharded):
        if x.mesh is not mesh or x.sharding.spec != ("data", "space"):
            raise ValueError("a Sharded input must be placed on this mesh with batch_row_sharding")
        return x
    return place(x, batch_row_sharding(mesh))


def _by_frame(mesh: Mesh, fn: Callable, *xs: Sharded):
    """fn(*[the ns row blocks of one frame] per input) -> tuple of per-shard
    lists of maps, for every frame; reassembled into Sharded outputs. Frame k
    of every data row goes out before frame k + 1 of any, so each row's
    devices get work from the first frame on."""
    nd, ns = mesh.shape["data"], mesh.shape["space"]
    b = xs[0].blocks[0][0].shape[0]
    per = [[fn(*[[x.blocks[i][j][k] for j in range(ns)] for x in xs]) for i in range(nd)]
           for k in range(b)]
    outs = [[[torch.stack([per[k][i][o][j] for k in range(b)]) for j in range(ns)]
             for i in range(nd)] for o in range(len(per[0][0]))]
    sharding = batch_row_sharding(mesh)
    return tuple(Sharded(sharding, out, xs[0].shape) for out in outs)


def _extend(blocks: Sequence[torch.Tensor], n: int):
    """Each shard's rows with n rows of each interior neighbour -> (extended
    blocks, rows added on top of each)."""
    if n == 0 or len(blocks) == 1:
        return list(blocks), [0] * len(blocks)
    with span("mesh.exchange"):
        tops, bots = from_prev(blocks, n), from_next(blocks, n)
        ext = [torch.cat([t for t in (top, blk, bot) if t is not None])
               for top, blk, bot in zip(tops, blocks, bots)]
    return ext, [0 if top is None else n for top in tops]


def sharded_sgbm_disparity(mesh: Mesh, left, right, cfg: SGBMConfig, halo: int = 32,
                           exact: bool = False):
    """(B, H, W) uint8 pairs -> (disparity, valid), each Sharded (B, H, W)
    over ('data', 'space'). Halo warm-start by default; exact=True hands DP
    carries between shards instead (sharded_sgbm_disparity_exact), the
    single-device maps bit for bit."""
    if exact:
        return sharded_sgbm_disparity_exact(mesh, left, right, cfg)
    _refuse_block_matching(cfg, "halo")
    L, R = _on_mesh(mesh, left), _on_mesh(mesh, right)
    ns = mesh.shape["space"]
    halo = 0 if ns == 1 else min(halo, L.shape[1] // ns)
    core = cfg.with_(speckle_window_size=0)

    def frame(ls, rs):
        h = ls[0].shape[0]
        le, tops = _extend(ls, halo)
        re, _ = _extend(rs, halo)
        maps = [DP.sgbm_disparity(a, b, core) for a, b in zip(le, re)]
        return ([d[t:t + h] for (d, _), t in zip(maps, tops)],
                [v[t:t + h] for (_, v), t in zip(maps, tops)])

    disp, valid = _by_frame(mesh, frame, L, R)
    if cfg.speckle_window_size > 0:
        valid = _sharded_speckle_with_margin(mesh, disp, valid, cfg)
    return disp, valid


def _refuse_block_matching(cfg: SGBMConfig, mode: str) -> None:
    if DP.block_matching(cfg):
        raise ValueError(f"sharded SGBM ({mode} mode) runs 5 or 8 paths; block matching "
                         "(num_directions=0) runs on one device: ops.disparity.sgbm_disparity")


def _exact_frame(ls: List[torch.Tensor], rs: List[torch.Tensor], cfg: SGBMConfig):
    """One frame's row blocks -> per-shard (disp, valid), the single-device
    maps' rows exactly (module docstring)."""
    ns = len(ls)
    h = ls[0].shape[0]
    hb = DP.cost_halo(cfg.block_size)
    if ns > 1 and h < hb:
        raise ValueError(f"shards of {h} rows: the exact cost volume needs {hb} rows of "
                         "each neighbour")
    le, tops = _extend(ls, hb)
    re, _ = _extend(rs, hb)
    Cs = [DP.sgbm_cost(a, b, cfg)[t:t + h] for a, b, t in zip(le, re, tops)]
    groups = [g for g in SK.delta_groups(cfg.num_directions, EXACT_FUSED) if g]
    vols = [[torch.empty_like(C) for _ in groups] for C in Cs]
    # Wavefront order: direction k of the shard at position p along the path
    # goes out at step k + p; a shard's carry is consumed one step after it
    # was made.
    order = [(gi, d) for gi, g in enumerate(groups) for d in g]
    tasks = sorted((k + (0 if dy == 0 else (j if dy > 0 else ns - 1 - j)), j, k)
                   for k, (_, (dx, dy)) in enumerate(order) for j in range(ns))
    carries, written = {}, set()
    for _, j, k in tasks:
        gi, (dx, dy) = order[k]
        cin = cout = None
        if dy != 0 and ns > 1:
            if 0 <= j - dy < ns:  # the shard before this one along the path
                cin = carries.pop((j - dy, k)).to(Cs[j].device, non_blocking=True)
            if 0 <= j + dy < ns:
                cout = carries[(j, k)] = torch.empty(Cs[j].shape[1:], dtype=torch.int32,
                                                     device=Cs[j].device)
        SK.path_sweep(Cs[j], vols[j][gi], dx, dy, cfg.p1, cfg.p2, (j, gi) in written, cin, cout)
        written.add((j, gi))
    disps, valids = [], []
    for j in range(ns):
        maps = SK.sweep_wta(Cs[j], vols[j], cfg.num_directions, cfg.p1, cfg.p2,
                            cfg.uniqueness_ratio, cfg.min_disparity, EXACT_FUSED)
        Cs[j] = vols[j] = None
        disp, valid = DP.sgbm_post(*maps, cfg)
        disps.append(disp)
        valids.append(valid)
    return disps, valids


def sharded_sgbm_disparity_exact(mesh: Mesh, left, right, cfg: SGBMConfig):
    """Row-sharded SGBM bit-identical to the single-device ``sgbm_disparity``
    on any mesh shape (module docstring): exact cost halos, carried
    vertical and diagonal sweeps, a horizontal fused WTA, the LR check and
    the sharded speckle filter."""
    _refuse_block_matching(cfg, "exact")
    L, R = _on_mesh(mesh, left), _on_mesh(mesh, right)
    DP.validate(L.shape[1], L.shape[2], cfg)
    disp, valid = _by_frame(mesh, lambda ls, rs: _exact_frame(ls, rs, cfg), L, R)
    if cfg.speckle_window_size > 0:
        valid = _sharded_speckle_with_margin(mesh, disp, valid, cfg)
    return disp, valid


# ---------------------------------------------------------------------------
# Sharded speckle filter
# ---------------------------------------------------------------------------

def _local_labels(disp: torch.Tensor, valid: torch.Tensor, max_diff: float) -> torch.Tensor:
    """The flood's fixpoint labels of one shard: the label kernel on a CUDA
    device, the plain flood run to convergence on the CPU."""
    if disp.device.type == "cpu":
        return SPK.speckle_labels_plain(disp, valid, max_diff, max_rounds=disp.numel() + 1)[0]
    return SPK.speckle_labels_cuda(disp, valid, max_diff)


def _roots(a: np.ndarray, b: np.ndarray):
    """Connected components of the graph with edges (a[e], b[e]) -> (nodes,
    one root index per node): min-label hooking with pointer jumping."""
    nodes, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
    ea, eb = inv[:a.size], inv[a.size:]
    parent = np.arange(nodes.size)
    while True:
        lo = np.minimum(parent[ea], parent[eb])
        new = parent.copy()
        np.minimum.at(new, ea, lo)
        np.minimum.at(new, eb, lo)
        new = new[new]
        if np.array_equal(new, parent):
            return nodes, parent
        parent = new


def _piece_sizes(lab: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int64: how many pixels of a label map (rows, w) carry each label,
    with no host sync. Each row is cut into runs of one label, and a run's
    length is added once, at its last pixel, into its label's count: a
    component's pixels would otherwise all add into one count, one after the
    other. The other pixels add nothing, each into a spare count of its own."""
    h, w = lab.shape
    dev = lab.device
    last = torch.ones((h, w), dtype=torch.bool, device=dev)
    last[:, :-1] = lab[:, :-1] != lab[:, 1:]
    x = torch.arange(w, device=dev).expand(h, w)
    before = torch.full((h, w), -1, dtype=torch.int64, device=dev)
    before[:, 1:] = torch.where(last[:, :-1], x[:, :-1], -1)
    run = x - torch.cummax(before, 1).values  # the run's length at its last pixel
    spare = n + torch.arange(h * w, device=dev).view(h, w)
    idx = torch.where(last, lab.long(), spare).reshape(-1)
    counts = torch.zeros(n + h * w, dtype=torch.int64, device=dev)
    return counts.index_add_(0, idx, torch.where(last, run, 0).reshape(-1))[:n]


def _to_host(x: torch.Tensor) -> np.ndarray:
    """The join's one copy to the host, which waits for the batch's SGBM."""
    return x.cpu().numpy()


def _boundary_records(top, below, max_diff: float, dev) -> torch.Tensor:
    """(5, b, W) int64 on `dev`: for each column of the boundary between two
    shards of one data row, in each of its b frames, the pieces on either
    side (numbered as in _speckle_batch), their sizes, and whether they are
    joined there: both valid and |d - d'| <= max_diff in f32, as within a
    shard. `top` and `below` are the shards' (maps, valid, labels as indices
    into sizes, sizes, first piece number)."""
    d, v, lab, sz, first = top
    d2, v2, lab2, sz2, first2 = below
    here = d.device
    la = lab[:, -1]
    sb = sz2[lab2[:, 0]].to(here)  # read on the shard below's device
    lb = lab2[:, 0].to(here)
    joined = (((d[:, -1].to(torch.float32) - d2[:, 0].to(here, torch.float32)).abs() <= max_diff)
              & v[:, -1] & v2[:, 0].to(here))
    # a run of joined columns between the same two pieces is one edge
    repeat = torch.zeros_like(joined)
    repeat[:, 1:] = joined[:, :-1] & (la[:, 1:] == la[:, :-1]) & (lb[:, 1:] == lb[:, :-1])
    rec = torch.stack([la + first, lb + first2, sz[la], sb, (joined & ~repeat).long()])
    return rec.to(dev)


def _join_sizes(rec: np.ndarray):
    """Host records (..., 5, b, W) -> (pieces that meet another across a
    boundary, sorted; the summed size of the component each belongs to)."""
    r = np.moveaxis(rec, -3, 0).reshape(5, -1)
    joined = r[4] != 0
    a, b = r[0][joined], r[1][joined]
    if not a.size:
        return a, a
    nodes, root = _roots(a, b)
    _, at = np.unique(np.concatenate([a, b]), return_index=True)
    total = np.zeros(nodes.size, np.int64)
    np.add.at(total, root, np.concatenate([r[2][joined], r[3][joined]])[at])
    return nodes, total[root]


def _put_sizes(shards, nodes: np.ndarray, total: np.ndarray, span_n: int) -> None:
    """Write each joined piece's component size into its shard's sizes, with
    one non-blocking copy from pinned memory to each device. A shard owns
    the piece numbers [first, first + span_n)."""
    pieces: dict = {}  # device -> [(sizes tensor, indices, totals)]
    for *_, sz, first in shards:
        lo, hi = np.searchsorted(nodes, [first, first + span_n])
        if hi > lo:
            pieces.setdefault(sz.device, []).append((sz, nodes[lo:hi] - first, total[lo:hi]))
    for dev, items in pieces.items():
        host = torch.from_numpy(np.concatenate([x for _, idx, tot in items for x in (idx, tot)]))
        if dev.type == "cuda":
            host = host.pin_memory()
        flat = host.to(dev, non_blocking=True)
        start = 0
        for sz, idx, _ in items:
            m = idx.size
            sz.index_copy_(0, flat[start:start + m], flat[start + m:start + 2 * m])
            start += 2 * m


def _speckle_batch(mesh: Mesh, disp: Sharded, valid: Sharded, max_size: int, max_diff: float,
                   x0: int = 0) -> Sharded:
    """Keep masks of a batch, Sharded like `valid`: each frame's equal to the
    single-device filter on its columns x >= x0; the columns left of x0 come
    back not kept. Each shard labels its b frames and counts the pieces of
    all of them at once on its device; the records of every boundary are
    queued, brought to the host in one copy (one wait a batch) and joined by
    one union-find over the batch; the joined pieces' sizes go back in one
    copy a device. Piece `label` of frame k in shard (i, j) is numbered
    ((i * ns + j) * b + k) * n + label."""
    nd, ns = mesh.shape["data"], mesh.shape["space"]
    b = valid.blocks[0][0].shape[0]
    n = max(blk.shape[1] * (blk.shape[2] - x0) for row in valid.blocks for blk in row) + 1
    shards = []  # per data row, per shard: (maps, valid, labels, sizes, first piece number)
    for i in range(nd):
        row = []
        for j in range(ns):
            d, v = disp.blocks[i][j][:, :, x0:], valid.blocks[i][j][:, :, x0:]
            lab = torch.stack([_local_labels(d[k], v[k], max_diff) for k in range(b)])
            lab = lab.long() + n * torch.arange(b, device=lab.device)[:, None, None]
            sz = _piece_sizes(lab.view(-1, lab.shape[2]), b * n)
            row.append((d, v, lab, sz, (i * ns + j) * b * n))
        shards.append(row)
    if ns > 1:
        dev = mesh.devices[0][0]
        recs = torch.stack([_boundary_records(row[j], row[j + 1], max_diff, dev)
                            for row in shards for j in range(ns - 1)])
        with span("mesh.speckle.join"):
            nodes, total = _join_sizes(_to_host(recs))
            _put_sizes([s for row in shards for s in row], nodes, total, b * n)
    blocks = [[DP.pad_margin(v & (sz[lab] > max_size), x0) for _, v, lab, sz, _ in row]
              for row in shards]
    return Sharded(batch_row_sharding(mesh), blocks, valid.shape)


def sharded_speckle_filter(mesh: Mesh, disp, valid, max_speckle_size: int = 100,
                           max_diff: float = 32.0) -> Sharded:
    """Keep mask of the speckle filter, Sharded (B, H, W) like its inputs
    (placed with batch_row_sharding): valid pixels whose 4-connected
    component (|d - d'| <= max_diff) holds more than max_speckle_size
    pixels, over the whole frame (cv2.filterSpeckles)."""
    if max_speckle_size < 0:
        raise ValueError(f"max_speckle_size={max_speckle_size} must be >= 0")
    return _speckle_batch(mesh, _on_mesh(mesh, disp), _on_mesh(mesh, valid), max_speckle_size,
                          max_diff)


def _sharded_speckle_with_margin(mesh: Mesh, disp: Sharded, valid: Sharded,
                                 cfg: SGBMConfig) -> Sharded:
    """The sharded speckle filter on the columns right of the margin
    (ops.disparity.margin; invalid by construction), as ops.disparity._speckle
    slices them; the margin comes back not kept."""
    return _speckle_batch(mesh, disp, valid, cfg.speckle_window_size, float(cfg.speckle_range),
                          DP.margin(cfg)[0])
