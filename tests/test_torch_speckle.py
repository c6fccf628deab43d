"""Port vs JAX reference: the speckle filter ("propagate" backend).

The port's plain flood runs here (CPU tensors); the reference runs its XLA
flood (``_seg_min_flood``, ``speckle_filter(use_pallas=False)``), its TPU
flood kernel ``flood_round_pallas`` in interpret mode, its sorted size test
``_component_keep_sort`` and the exact host filter ``native.filter_speckles``.
Labels and masks are integers and bools: all comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu import native as ref_native
from stereo_reconstruction_cv_tpu.config import SGBMConfig
from stereo_reconstruction_cv_tpu.ops import disparity as RD
from stereo_reconstruction_cv_tpu.ops.pallas.speckle_pallas import flood_round_pallas
from stereo_reconstruction_cv_tpu_torch import convert
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops.cuda import speckle as SPK

MAX_DIFF = 5.0


def _speckled(seed, H=48, W=256, p_invalid=0.4, block=1):
    """Random disparities x60 (constant over block x block squares), a share
    p_invalid of the pixels invalid and zeroed."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((-(-H // block), -(-W // block))) * 60
    disp = np.repeat(np.repeat(coarse, block, 0), block, 1)[:H, :W].astype(np.float32)
    valid = rng.random((H, W)) >= p_invalid
    return np.where(valid, disp, 0.0).astype(np.float32), valid


def _serpentine(H, W, turns, transpose=False):
    """One valid snake of constant disparity: `turns` + 1 one-pixel stripes
    joined alternately at their right and left ends; each turn costs the
    flood one more round."""
    if transpose:
        d, v = _serpentine(W, H, turns)
        return d.T.copy(), v.T.copy()
    if 2 * turns + 1 > H:
        raise ValueError("too many turns for the height")
    valid = np.zeros((H, W), bool)
    for k in range(turns + 1):
        valid[2 * k, 1:W - 1] = True
        if k < turns:
            valid[2 * k + 1, W - 2 if k % 2 == 0 else 1] = True
    return np.where(valid, 7.0, 0.0).astype(np.float32), valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_conn(disp, valid):
    H, W = disp.shape
    d, v = jnp.asarray(disp), jnp.asarray(valid)
    ch = jnp.concatenate([jnp.zeros((H, 1), bool),
                          (jnp.abs(d[:, 1:] - d[:, :-1]) <= MAX_DIFF) & v[:, 1:] & v[:, :-1]], 1)
    cv = jnp.concatenate([jnp.zeros((1, W), bool),
                          (jnp.abs(d[1:] - d[:-1]) <= MAX_DIFF) & v[1:] & v[:-1]], 0)
    return ch, cv


@jax.jit
def _ref_round(lab, ch, cv):
    big = jnp.int32(lab.size)
    return RD._seg_min_flood(RD._seg_min_flood(lab, ch, 1, big), cv, 0, big)


def _ref_fixpoint(disp, valid):
    """The reference's XLA flood iterated to its fixpoint, with its round count."""
    H, W = disp.shape
    ch, cv = _ref_conn(disp, valid)
    big = jnp.int32(H * W)
    lab = jnp.where(jnp.asarray(valid), jnp.arange(H * W, dtype=jnp.int32).reshape(H, W), big)
    for rounds in range(1, 512):
        new = _ref_round(lab, ch, cv)
        if bool(jnp.all(new == lab)):
            return np.asarray(lab), rounds
        lab = new
    raise AssertionError("reference flood did not converge")


@pytest.mark.parametrize("seed,block", [(0, 1), (1, 4)])
def test_flood_round_matches_reference(seed, block):
    disp, valid = _speckled(seed, block=block)
    ch, cv = _ref_conn(disp, valid)
    ch_t, cv_t = SPK.connectivity(_t(disp), _t(valid), MAX_DIFF)
    np.testing.assert_array_equal(ch_t.numpy(), np.asarray(ch))
    np.testing.assert_array_equal(cv_t.numpy(), np.asarray(cv))
    lab = SPK.initial_labels(_t(valid))
    big = jnp.int32(disp.size)
    ref = RD._seg_min_flood(jnp.asarray(lab.numpy()), ch, 1, big)
    np.testing.assert_array_equal(SPK.seg_min_flood(lab, ch_t, 1, disp.size).numpy(), np.asarray(ref))
    ref = RD._seg_min_flood(ref, cv, 0, big)
    np.testing.assert_array_equal(SPK.flood_round(lab, ch_t, cv_t).numpy(), np.asarray(ref))


def test_fixpoint_matches_reference_and_pallas_interpret():
    disp, valid = _speckled(0)
    fix, _ = _ref_fixpoint(disp, valid)
    got, converged = SPK.speckle_labels_plain(_t(disp), _t(valid), MAX_DIFF)
    assert converged
    np.testing.assert_array_equal(got.numpy(), fix)
    # The TPU kernel, iterated to its own fixpoint, lands on the same labels.
    ch, cv = _ref_conn(disp, valid)
    lab = jnp.asarray(SPK.initial_labels(_t(valid)).numpy())
    for _ in range(64):
        lab, changed = flood_round_pallas(lab, ch.astype(jnp.int32), cv.astype(jnp.int32),
                                          interpret=True)
        if not bool(changed):
            break
    assert not bool(changed)
    np.testing.assert_array_equal(np.asarray(lab), got.numpy())


def test_fixpoint_label_is_component_minimum():
    """The label map the kernel computes directly: each valid pixel gets the
    smallest linear index of its component, each invalid pixel H*W."""
    disp, valid = _speckled(2, 24, 40, block=2)
    got, _ = SPK.speckle_labels_plain(_t(disp), _t(valid), MAX_DIFF)
    got = got.numpy().ravel()
    H, W = disp.shape
    assert (got[~valid.ravel()] == H * W).all()
    idx = np.flatnonzero(valid.ravel())
    assert (got[idx] <= idx).all() and (got[got[idx]] == got[idx]).all()


def test_keep_matches_reference_filter():
    disp, valid = _speckled(1, p_invalid=0.3, block=4)
    got = SPK.speckle_filter(_t(disp), _t(valid), 20, MAX_DIFF).numpy()
    ref = np.asarray(RD.speckle_filter(jnp.asarray(disp), jnp.asarray(valid), 20, MAX_DIFF,
                                       use_pallas=False))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("seed,block,T", [(0, 1, 2), (1, 4, 20), (3, 8, 100)])
def test_keep_matches_sort_and_host_filter(seed, block, T):
    """The bincount size test == the reference's sorted one on the same
    fixpoint == the exact host union-find."""
    disp, valid = _speckled(seed, p_invalid=0.3, block=block)
    got = SPK.speckle_filter(_t(disp), _t(valid), T, MAX_DIFF).numpy()
    fix, _ = _ref_fixpoint(disp, valid)
    keep_sort = np.asarray(RD._component_keep_sort(jnp.asarray(fix), T)) & valid
    np.testing.assert_array_equal(got, keep_sort)
    np.testing.assert_array_equal(got, ref_native.filter_speckles(disp, valid, T, MAX_DIFF))
    assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("T", [0, 1, 7])
def test_component_of_exactly_T_is_dropped(T):
    disp = np.zeros((6, 30), np.float32)
    valid = np.zeros((6, 30), bool)
    valid[1, 2:2 + T] = True           # T pixels: dropped
    valid[4, 2:3 + T] = True           # T + 1 pixels: kept
    disp[valid] = 3.0
    got = SPK.speckle_filter(_t(disp), _t(valid), T, MAX_DIFF).numpy()
    assert not got[1].any() and got[4].sum() == T + 1
    np.testing.assert_array_equal(got, ref_native.filter_speckles(disp, valid, T, MAX_DIFF))


def test_all_invalid_map():
    disp = np.full((9, 17), 4.0, np.float32)
    valid = np.zeros((9, 17), bool)
    labels, converged = SPK.speckle_labels_plain(_t(disp), _t(valid), MAX_DIFF)
    assert converged and (labels.numpy() == disp.size).all()
    assert not SPK.speckle_filter(_t(disp), _t(valid), 0, MAX_DIFF).any()


def test_serpentine_needs_many_rounds():
    disp, valid = _serpentine(48, 64, turns=23)
    fix, rounds = _ref_fixpoint(disp, valid)
    assert rounds >= 23
    got, converged = SPK.speckle_labels_plain(_t(disp), _t(valid), MAX_DIFF)
    assert converged
    np.testing.assert_array_equal(got.numpy(), fix)
    assert (got.numpy()[valid] == np.flatnonzero(valid.ravel())[0]).all()
    T = int(valid.sum()) - 1
    keep = SPK.speckle_filter(_t(disp), _t(valid), T, MAX_DIFF).numpy()
    np.testing.assert_array_equal(keep, valid)
    np.testing.assert_array_equal(keep, ref_native.filter_speckles(disp, valid, T, MAX_DIFF))


def test_unconverged_flood_stops_at_max_rounds_like_the_reference():
    """A snake of 100 turns needs more than max_rounds = 64 rounds: the plain
    flood, like the reference's, stops short of the fixpoint, so its mask
    differs from the exact filter (the CUDA kernel's result)."""
    disp, valid = _serpentine(24, 202, turns=100, transpose=True)
    labels, converged = SPK.speckle_labels_plain(_t(disp), _t(valid), MAX_DIFF)
    assert not converged
    T = int(valid.sum()) - 1
    got = SPK.speckle_filter(_t(disp), _t(valid), T, MAX_DIFF).numpy()
    ref = np.asarray(RD.speckle_filter(jnp.asarray(disp), jnp.asarray(valid), T, MAX_DIFF,
                                       use_pallas=False))
    np.testing.assert_array_equal(got, ref)
    exact = ref_native.filter_speckles(disp, valid, T, MAX_DIFF)
    assert exact.sum() == valid.sum() and got.sum() == 0


def test_speckle_margin_slice_matches_reference():
    """_speckle labels only x >= min_disp + num_disp and pads the margin back
    as not kept, as the reference's does."""
    min_disp, num_disp = 3, 16
    disp, valid = _speckled(5, 40, 120, p_invalid=0.3, block=3)
    x0 = min_disp + num_disp
    disp[:, :x0] = min_disp - 1
    valid[:, :x0] = False
    cfg = SGBMConfig(min_disparity=min_disp, num_disparities=num_disp,
                     speckle_window_size=20, speckle_range=int(MAX_DIFF))
    got = DP._speckle(_t(disp), _t(valid), convert.sgbm_config(cfg)).numpy()
    ref = np.asarray(RD._speckle(jnp.asarray(disp), jnp.asarray(valid), cfg))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, ref_native.filter_speckles(disp, valid, 20, MAX_DIFF))
    assert got.shape == disp.shape and not got[:, :x0].any() and got.any()


def test_cpu_dispatch_and_argument_checks():
    disp, valid = _speckled(6, 8, 16)
    before = dict(SPK.launches)
    SPK.speckle_filter(_t(disp), _t(valid), 3, MAX_DIFF)
    assert SPK.launches == before
    with pytest.raises(ValueError, match="bool"):
        SPK.speckle_filter(_t(disp), _t(valid.astype(np.uint8)), 3, MAX_DIFF)
    with pytest.raises(ValueError, match="shape"):
        SPK.speckle_filter(_t(disp), _t(valid[:, :5]), 3, MAX_DIFF)
    with pytest.raises(ValueError, match="CUDA"):
        SPK.speckle_labels_cuda(_t(disp), _t(valid), MAX_DIFF)


def _edge_case(kind, H, W, seed=0):
    """Maps for the reduced edge set: (disp f32, valid bool), with MAX_DIFF."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    valid = np.ones((H, W), bool)
    if kind == "random":
        return _speckled(seed, H, W, p_invalid=0.3, block=2)
    if kind == "all valid":
        disp = np.full((H, W), 7.0)
    elif kind == "ramp":  # one component: neighbours differ by 0.7 <= MAX_DIFF
        disp = 0.7 * (xx + yy)
    elif kind == "checkerboard":  # 5x5 blocks of disparities 30 apart
        disp = ((yy // 5 + xx // 5) % 2) * 30.0
        valid = rng.random((H, W)) >= 0.1
    elif kind == "banded":  # vertical bands of 13 columns, 20 apart
        disp = xx // 13 * 20.0
    elif kind == "comb":  # teeth on every third column, joined by the last row only
        disp = np.full((H, W), 7.0)
        valid = (xx % 3 == 0) | (yy == H - 1)
    elif kind == "serpentine":
        return _serpentine(H, W, (H - 1) // 2)
    else:
        raise ValueError(kind)
    return np.where(valid, disp, 0.0).astype(np.float32), valid


def _flood_to_fixpoint(valid, ch, cv):
    lab = SPK.initial_labels(valid)
    for _ in range(4096):
        new = SPK.flood_round(lab, ch, cv)
        if torch.equal(new, lab):
            return lab
        lab = new
    raise AssertionError("flood did not converge")


@pytest.mark.parametrize("H,W", [(70, 101), (33, 65)])
@pytest.mark.parametrize("kind", ["random", "all valid", "ramp", "checkerboard", "banded",
                                  "comb", "serpentine"])
def test_reduced_edges_reach_the_same_fixpoint(kind, H, W):
    """The edges the label kernel unites (runs, the vertical edges no joined
    square closes, the tile-border rule at tile width 32) connect the same
    components as every edge: the flood over them reaches the same fixpoint,
    which is the reference's."""
    disp, valid = _edge_case(kind, H, W)
    ch, cv = SPK.connectivity(_t(disp), _t(valid), MAX_DIFF)
    ch_k, cv_k = SPK.reduced_connectivity(ch, cv)
    assert not (ch_k & ~ch).any() and not (cv_k & ~cv).any()
    full = _flood_to_fixpoint(_t(valid), ch, cv)
    reduced = _flood_to_fixpoint(_t(valid), ch_k, cv_k)
    assert torch.equal(reduced, full)
    np.testing.assert_array_equal(full.numpy(), _ref_fixpoint(disp, valid)[0])
    if kind in ("all valid", "ramp"):
        # One component: about one vertical edge per tile column and row pair.
        assert int(cv_k.sum()) <= -(-W // SPK.TILE) * H
        assert int(ch_k.sum()) < int(ch.sum())


def test_reduced_edges_keep_tile_corners():
    """At a tile's corner pixel neither border rule drops an edge, so a pixel
    joined only to its left and upper neighbours stays in their component."""
    T = SPK.TILE
    valid = np.zeros((2 * T, 2 * T), bool)
    valid[T - 1:T + 1, T - 1:T + 1] = True  # a joined 2x2 square on the corner
    disp = np.where(valid, 3.0, 0.0).astype(np.float32)
    ch, cv = SPK.connectivity(_t(disp), _t(valid), MAX_DIFF)
    ch_k, cv_k = SPK.reduced_connectivity(ch, cv)
    assert bool(ch_k[T, T]) and bool(cv_k[T, T])
    lab = _flood_to_fixpoint(_t(valid), ch_k, cv_k).numpy()
    assert (lab[valid] == (T - 1) * 2 * T + T - 1).all()


def test_rows_keep_column_slices_uncopied():
    """The label and keep kernels read a column slice through its row
    stride; only a map whose rows are not unit-stride is copied."""
    full = torch.zeros((6, 40), dtype=torch.float32)
    view = full[:, 9:]
    t, stride = SPK._rows(view)
    assert t.data_ptr() == view.data_ptr() and stride == 40
    t, stride = SPK._rows(full.t())
    assert t.is_contiguous() and stride == 6
    t, stride = SPK._rows(full[:, 3:4])
    assert t.data_ptr() == full[:, 3:4].data_ptr() and stride == 40


def _keep_stress(kind, H, W):
    """The size test's stress maps (tests/test_torch_gpu.py), from disparities:
    (disp, valid)."""
    if kind == "one component":
        return np.full((H, W), 7.0, np.float32), np.ones((H, W), bool)
    if kind == "singletons":  # a checkerboard of disparities 30 apart: no edge joined
        disp = np.where(np.add.outer(np.arange(H), np.arange(W)) % 2 == 0, 10.0, 40.0)
        return disp.astype(np.float32), np.ones((H, W), bool)
    if kind == "all invalid":
        return np.full((H, W), 4.0, np.float32), np.zeros((H, W), bool)
    return _speckled(7, H, W, p_invalid=0.3, block=2)


@pytest.mark.parametrize("kind,T", [
    ("one component", 0), ("one component", 37 * 21 - 1), ("one component", 37 * 21),
    ("singletons", 0), ("singletons", 1), ("all invalid", 0), ("speckled", 0),
    ("speckled", 37 * 21),
])
def test_keep_stress_maps_match_sort_and_host_filter(kind, T):
    """The yardstick the card holds the keep kernel to: the plain bincount
    test equals the reference's sorted test on its fixpoint and the exact host
    filter, for T = 0, T >= H*W and the maps that stress the kernel (one
    component, a component per pixel, no valid pixel)."""
    H, W = 37, 21
    disp, valid = _keep_stress(kind, H, W)
    fix, _ = _ref_fixpoint(disp, valid)
    labels, converged = SPK.speckle_labels_plain(_t(disp), _t(valid), MAX_DIFF)
    assert converged
    np.testing.assert_array_equal(labels.numpy(), fix)
    got = SPK.speckle_keep_plain(labels, _t(valid), T).numpy()
    np.testing.assert_array_equal(got, np.asarray(RD._component_keep_sort(jnp.asarray(fix), T)) & valid)
    np.testing.assert_array_equal(got, ref_native.filter_speckles(disp, valid, T, MAX_DIFF))
    if kind == "singletons":
        assert len(np.unique(fix)) == H * W and got.all() == (T == 0)


def test_keep_kernel_argument_checks():
    labels = torch.zeros((6, 9), dtype=torch.int32)
    valid = torch.ones((6, 9), dtype=torch.bool)
    with pytest.raises(ValueError, match="int32"):
        SPK.speckle_keep_cuda(labels.long(), valid, 3)
    with pytest.raises(ValueError, match="shape"):
        SPK.speckle_keep_cuda(labels, valid[:, :4], 3)
    with pytest.raises(ValueError, match="CUDA"):
        SPK.speckle_keep_cuda(labels, valid, 3)
