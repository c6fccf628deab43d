"""Port vs JAX reference: the learned matcher's serving path.

The net (v4 weights and a seeded random init, at (2, 64, 96) and at the
ragged (1, 72, 104)), detection (both top-k branches, corner refinement on
and off), corner_subpix_patch, refine_matches_lk, the learned branch of
_match_for_geometry and estimate_geometry on the rendered 240x320 raw pair
of tests/test_torch_pipeline.py, the committed weights file against the
reference's restore of checkpoints/xfeat_v4, and the CLI. The reference
runs once a file (module-scoped fixtures); torch runs on one thread.

Run as a script, the file exports an orbax checkpoint of the reference to
the .npz the port reads (JAX, flax and orbax needed):

    python tests/test_torch_xfeat.py CHECKPOINT_DIR OUT.npz
"""

import functools
import os
import pathlib
import sys

if __name__ == "__main__":  # the export, run as a script from anywhere
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu.models import xfeat as RX
from stereo_reconstruction_cv_tpu_torch import convert
from stereo_reconstruction_cv_tpu_torch.calib import chessboard as PCB
from stereo_reconstruction_cv_tpu_torch.io import image as IO
from stereo_reconstruction_cv_tpu_torch.models import checkpoint as CKPT
from stereo_reconstruction_cv_tpu_torch.models import xfeat as PX
from stereo_reconstruction_cv_tpu_torch.ops import refine as PRF
from stereo_reconstruction_cv_tpu_torch.pipeline import stages
from stereo_reconstruction_cv_tpu_torch.utils import synth

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_CKPT = str(ROOT / "checkpoints" / "xfeat_v4")
RAW_K = np.array([[200.0, 0.0, 160.0], [0.0, 200.0, 120.0], [0.0, 0.0, 1.0]])
RAW_T = np.array([-0.3, 0.02, 0.01])


def restore_reference(ckpt_dir: str):
    """(flax XFeatNet, params) of an orbax checkpoint, restored by the
    reference's load_params onto a template of its own net's parameters (a
    plain restore asks for the device the checkpoint was saved on), as
    ``stages._xfeat_model`` restores it."""
    from stereo_reconstruction_cv_tpu.models import checkpoint as RCK

    model = RX.XFeatNet()
    like = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 1), jnp.float32))
    return model, RCK.load_params(os.path.abspath(ckpt_dir), like=like)


def export_xfeat_npz(ckpt_dir: str, out: str) -> dict:
    """Write the 36 arrays of an orbax XFeatNet checkpoint, flat under their
    flax paths ("params/ConvBlock_3/Conv_0/kernel", ...), to the .npz `out`."""
    from flax.traverse_util import flatten_dict

    _, params = restore_reference(ckpt_dir)
    flat = {k: np.asarray(v, np.float32) for k, v in flatten_dict(params, sep="/").items()}
    np.savez(out, **flat)
    return flat



# ---------------------------------------------------------------------------
# Fixtures: the reference's model and weights, the rendered scene
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensor ops run fastest on one thread here; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_v4():
    """(flax model, params) of the reference's restore of xfeat_v4 (what its
    CLI and config 4 load), also handed to its stages' model cache so that
    they skip the optimizer set-up of their own template."""
    from stereo_reconstruction_cv_tpu.pipeline import stages as RS

    model, params = restore_reference(REF_CKPT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(RS._XFEAT_CACHE, ("model", REF_CKPT), (model, params))
        yield model, params


@pytest.fixture(scope="module")
def port_v4():
    return CKPT.load_model(CKPT.default_checkpoint(), "cpu")


@pytest.fixture(scope="module")
def raw_pair(tmp_path_factory):
    """The raw 240x320 pair of tests/test_torch_pipeline.py (planes at
    2.5-5 m, 2 degrees about (0.2, 1, 0.1), T = (-0.3, 0.02, 0.01) m, JPEG
    quality 95), loaded as (H, W) uint8, and its rotation."""
    from PIL import Image

    R = synth.rotation_about((0.2, 1.0, 0.1), 2.0)
    left, right = synth.render_pair(RAW_K, R, RAW_T, 240, 320, seed=1)
    folder = tmp_path_factory.mktemp("raw")
    Image.fromarray(left.numpy()).convert("RGB").save(folder / "img1.jpg", quality=95)
    Image.fromarray(right.numpy()).convert("RGB").save(folder / "img2.jpg", quality=95)
    imL, imR = IO.load_stereo_pair(str(folder))
    return imL, imR, R


_JITTED = {}


def _jitted(name, model, max_keypoints, nms_radius, image_refine):
    key = (name, id(model), max_keypoints, nms_radius, image_refine)
    if key not in _JITTED:
        fn = getattr(RX, name)
        _JITTED[key] = jax.jit(lambda params, *imgs: fn(params, model, *imgs, max_keypoints,
                                                         nms_radius, image_refine))
    return _JITTED[key]


def ref_detect(params, model, img, max_keypoints=1024, nms_radius=4, image_refine=True):
    """The reference's detect under jax.jit: one compiled program runs in
    ~2 s here where the op-by-op first call compiles for ~15 s."""
    return _jitted("detect", model, max_keypoints, nms_radius, image_refine)(params, img)


def ref_detect_pair(params, model, img_left, img_right, max_keypoints=1024, nms_radius=4,
                    image_refine=True):
    """The reference's detect_pair under jax.jit."""
    return _jitted("detect_pair", model, max_keypoints, nms_radius, image_refine)(
        params, img_left, img_right)


def _random_weights(seed: int):
    """Seeded random parameters of the reference's tree (kernels N(0,
    1/fan-in), LayerNorm scales about 1, biases about 0): (flax params, the
    port's net carried across by convert.xfeat_state_dict)."""
    from flax.traverse_util import unflatten_dict

    rng = np.random.default_rng(seed)
    with np.load(CKPT.default_checkpoint()) as z:
        shapes = {k: z[k].shape for k in z.files}
    flat = {}
    for k, shape in sorted(shapes.items()):
        if k.endswith("kernel"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            v = (k.endswith("scale") + 0.2 * rng.standard_normal(shape))
        flat[k] = v.astype(np.float32)
    net = PX.XFeatNet()
    net.load_state_dict(convert.xfeat_state_dict(flat))
    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return params, net.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# The weights
# ---------------------------------------------------------------------------

def test_committed_weights_equal_the_reference_restore(ref_v4, tmp_path):
    from flax.traverse_util import flatten_dict

    want = {k: np.asarray(v) for k, v in flatten_dict(ref_v4[1], sep="/").items()}
    with np.load(CKPT.default_checkpoint(), allow_pickle=False) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want) and len(got) == 36
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sum(v.size for v in got.values()) == 269_882
    # the export writes the same file again
    out = tmp_path / "v4.npz"
    export_xfeat_npz(REF_CKPT, str(out))
    with np.load(out) as z:
        assert all(np.array_equal(z[k], want[k]) for k in want) and len(z.files) == 36


def test_state_dict_conversion_refuses_what_does_not_fit():
    with np.load(CKPT.default_checkpoint()) as z:
        flat = {k: z[k] for k in z.files}
    sd = convert.xfeat_state_dict(flat)
    assert set(sd) == set(PX.XFeatNet().state_dict())
    assert tuple(sd["blocks.3.conv.weight"].shape) == (48, 24, 3, 3)
    np.testing.assert_array_equal(sd["blocks.3.conv.weight"].numpy(),
                                  flat["params/ConvBlock_3/Conv_0/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["blocks.0.norm.weight"].numpy(),
                                  flat["params/ConvBlock_0/LayerNorm_0/scale"])
    with pytest.raises(KeyError, match="missing"):
        convert.xfeat_state_dict({k: v for k, v in flat.items() if "Conv_5" not in k})
    with pytest.raises(KeyError, match="unexpected"):
        convert.xfeat_state_dict({**flat, "params/Conv_6/bias": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        convert.xfeat_state_dict({**flat, "params/Conv_2/bias": np.zeros(64, np.float32)})


def test_load_params_refuses_an_orbax_directory():
    with pytest.raises(CKPT.CheckpointFormatError, match="test_torch_xfeat.py"):
        CKPT.load_params(REF_CKPT, "cpu")
    assert issubclass(CKPT.CheckpointFormatError, ValueError)
    assert os.path.getsize(CKPT.default_checkpoint()) < 1_200_000


# ---------------------------------------------------------------------------
# The net
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 72, 104)])  # H/8, W/8 even; both odd
@pytest.mark.parametrize("weights", ["v4", "random"])
def test_net_matches_reference(ref_v4, port_v4, weights, shape):
    model, params = ref_v4
    net = port_v4
    if weights == "random":
        params, net = _random_weights(7)
    x = np.random.default_rng(shape[1]).random(shape, dtype=np.float32)
    want = jax.jit(model.apply)(params, jnp.asarray(x)[..., None])
    got = net(torch.from_numpy(x))
    for name, a, b in zip(("logits", "desc", "rel"), want, got):
        a = np.asarray(a)
        assert b.shape == a.shape, name
        err = np.abs(b.numpy() - a).max() / np.abs(a).max()
        assert err <= 1e-5, (name, err)
    heat = np.asarray(RX.heatmap_from_logits(want[0]))
    got_heat = PX.heatmap_from_logits(torch.tensor(np.asarray(want[0])))
    assert np.abs(got_heat.numpy() - heat).max() <= 1e-7


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

def _refined_exact(img, k0):
    """detect's gated corner refinement of the keypoints k0, in float64."""
    k0 = torch.from_numpy(np.asarray(k0, np.float64))
    r = PCB.corner_subpix_patch(torch.tensor(img), k0, win=3, max_iter=5, max_drift=5.0)
    keep = (r - k0).abs().amax(-1) <= 1.5
    return torch.where(keep[:, None], r, k0).numpy()


def _hold_features(fr, fp, exact=None):
    """Port features fp against the reference's fr: equal masks; on the
    valid rows (a masked row is padding, placed on a zero heatmap), scores
    and descriptors within 1e-5 and keypoints within 1e-4 px. Where the
    keypoints went through the corner refinement, the reference's own
    float32 error against the float64 solve (`exact`) is added to the 1e-4:
    its 2x2 solves cancel, and a float32 result of either package lies up
    to ~2e-4 px from the exact one on ill-conditioned corners."""
    valid = np.asarray(fr.mask)
    np.testing.assert_array_equal(fp.mask.numpy(), valid)
    kr = np.asarray(fr.keypoints)[valid]
    err = np.abs(fp.keypoints.numpy()[valid] - kr).max(-1)
    tol = 1e-4 if exact is None else 1e-4 + np.abs(kr - exact[valid]).max(-1)
    assert (err <= tol).all(), (err.max(), np.argmax(err - tol))
    assert np.abs(fp.scores.numpy() - np.asarray(fr.scores))[valid].max() <= 1e-5
    assert np.abs(fp.descriptors.numpy() - np.asarray(fr.descriptors))[valid].max() <= 1e-5


@pytest.mark.parametrize("image_refine", [True, False])
@pytest.mark.parametrize("case", ["tiled-pair", "flat-single"])
def test_detect_matches_reference(ref_v4, port_v4, raw_pair, case, image_refine):
    """The tiled top-k through detect_pair at (64, 96), maxk 128; the flat
    one through detect at the ragged (72, 104), maxk 488 > (H/4)(W/4)."""
    model, params = ref_v4
    imL, imR, _ = raw_pair
    if case == "tiled-pair":
        imgs, maxk = (imL[40:104, 60:156], imR[40:104, 60:156]), 128
        want = ref_detect_pair(params, model, *map(jnp.asarray, imgs), maxk,
                              image_refine=image_refine)
        got = PX.detect_pair(port_v4, *map(torch.tensor, imgs), maxk,
                             image_refine=image_refine)
        plain = (ref_detect_pair(params, model, *map(jnp.asarray, imgs), maxk, image_refine=False)
                 if image_refine else None)
    else:
        imgs, maxk = (imR[100:172, 100:204],), 18 * 26 + 20
        want = (ref_detect(params, model, jnp.asarray(imgs[0]), maxk, image_refine=image_refine),)
        got = (PX.detect(port_v4, torch.tensor(imgs[0]), maxk, image_refine=image_refine),)
        plain = ((ref_detect(params, model, jnp.asarray(imgs[0]), maxk, image_refine=False),)
                 if image_refine else None)
    for i, (img, fr, fp) in enumerate(zip(imgs, want, got)):
        assert fp.keypoints.shape == (maxk, 2) and fp.descriptors.shape == (maxk, 64)
        assert 50 < int(fp.mask.sum()) < maxk
        exact = _refined_exact(img, plain[i].keypoints) if image_refine else None
        _hold_features(fr, fp, exact)


def test_detect_pair_equals_two_detects(port_v4, raw_pair):
    imL, imR, _ = raw_pair
    l, r = torch.from_numpy(imL[:64, :96]), torch.from_numpy(imR[:64, :96])
    pair = PX.detect_pair(port_v4, l, r, 64)
    for img, f in zip((l, r), pair):
        one = PX.detect(port_v4, img, 64)
        for a, b in zip(one, f):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_pair_detection_of_unequal_shapes_runs_two_forwards(raw_pair):
    """The stage crops to multiples of 8 and, for a pair of two shapes,
    detects each image alone."""
    imL, imR, _ = raw_pair
    l, r = torch.tensor(imL[:61, :99]), torch.tensor(imR[:70, :90])
    fl, fr = stages._learned_features_pair(l, r, 64, None)
    model = stages._xfeat_model(None, torch.device("cpu"))
    for img, f in ((l[:56, :96], fl), (r[:64, :88], fr)):
        one = PX.detect(model, img, 64)
        assert all(torch.equal(a, b) for a, b in zip(one, f))
    assert float(fl.keypoints[:, 0].max()) < 96 and float(fr.keypoints[:, 1].max()) < 64


# ---------------------------------------------------------------------------
# The refinements
# ---------------------------------------------------------------------------

def test_corner_subpix_patch_matches_reference(raw_pair):
    """Random corners over the image, and corners on and past its border
    (their patches come from the edge-padded image)."""
    from stereo_reconstruction_cv_tpu.calib.chessboard import corner_subpix_patch

    img = raw_pair[0]
    rng = np.random.default_rng(2)
    pts = np.concatenate([
        rng.uniform(0, [320, 240], (600, 2)),
        [[0, 0], [319, 239], [2, 50], [317, 90], [100, 2], [200, 238.5], [-1.5, 3], [321, 100]],
    ]).astype(np.float32)
    want = np.asarray(corner_subpix_patch(jnp.asarray(img), jnp.asarray(pts), win=3,
                                          max_iter=5, max_drift=5.0))
    got = PCB.corner_subpix_patch(torch.from_numpy(img), torch.from_numpy(pts), win=3,
                                  max_iter=5, max_drift=5.0).numpy()
    exact = PCB.corner_subpix_patch(torch.from_numpy(img), torch.from_numpy(pts).double(), win=3,
                                    max_iter=5, max_drift=5.0).numpy()
    err = np.abs(got - want).max(-1)
    # 1e-4 px, plus the reference's own float32 error on ill-conditioned
    # corners (see _hold_features)
    assert (err <= 1e-4 + np.abs(want - exact).max(-1)).all(), err.max()
    assert (err <= 1e-4).mean() >= 0.99
    assert np.abs(got - exact).max() <= 2e-4
    assert np.isfinite(got).all() and (np.abs(got[-8:] - pts[-8:]) <= 10).all()


def test_corner_subpix_patch_batch_equals_single_images(raw_pair):
    """A (B, H, W) batch with (B, N, 2) corners, as detect_pair refines both
    images at once, gives each image's own result."""
    imgs = torch.from_numpy(np.stack(raw_pair[:2]))
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(-2, [322, 242], (2, 300, 2)).astype(np.float32))
    got = PCB.corner_subpix_patch(imgs, pts, win=3, max_iter=5, max_drift=5.0)
    assert got.shape == (2, 300, 2)
    for i in range(2):
        one = PCB.corner_subpix_patch(imgs[i], pts[i], win=3, max_iter=5, max_drift=5.0)
        torch.testing.assert_close(got[i], one, rtol=0, atol=1e-5)


def _lk_scene():
    """tests/test_refine.py's scene: a smooth texture and its bilinear shift
    by (0.7, -0.4); coarse matches rounded, eight off by a further pixel."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_refine import _shift_bilinear, _textured

    img = _textured(160, 200)
    shifted = _shift_bilinear(img, 0.7, -0.4).astype(np.float32)
    pts = np.random.default_rng(1).uniform(20, [180, 140], size=(64, 2))
    pr0 = np.round(pts + [0.7, -0.4])
    pr0[:8] += 1.0
    # border matches (rejected) and one that drifts in from outside
    pts = np.concatenate([pts, [[5.0, 5.0], [3.0, 80.0], [195.0, 100.0], [100.0, 158.0]]])
    pr0 = np.concatenate([pr0, [[5.0, 5.0], [3.5, 80.0], [196.0, 100.0], [100.0, 159.0]]])
    return img, shifted, pts, pr0


@pytest.mark.parametrize("win,iters", [(7, 8), (9, 16), (3, 4)])
def test_refine_matches_lk_matches_reference(win, iters):
    from stereo_reconstruction_cv_tpu.ops.refine import refine_matches_lk

    img, shifted, pts, pr0 = _lk_scene()
    want, wmoved = refine_matches_lk(jnp.asarray(img), jnp.asarray(shifted), jnp.asarray(pts),
                                     jnp.asarray(pr0), win=win, iters=iters)
    got, moved = PRF.refine_matches_lk(torch.from_numpy(img), torch.from_numpy(shifted),
                                       torch.from_numpy(pts), torch.from_numpy(pr0),
                                       win=win, iters=iters)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4
    assert np.abs(moved.numpy() - np.asarray(wmoved)).max() <= 1e-4
    np.testing.assert_array_equal((moved.numpy() != 0).any(-1), (np.asarray(wmoved) != 0).any(-1))
    if win == 7:
        err = np.abs(got.numpy()[:64] - (pts[:64] + [0.7, -0.4])).max(-1)
        assert np.median(err) < 0.05 and (err < 0.1).mean() >= 0.9
    if win > 5:  # the first two border matches lie within win of the border
        assert (moved.numpy()[64:66] == 0).all()


def test_refine_matches_lk_keeps_degenerate_and_border_points():
    from stereo_reconstruction_cv_tpu.ops.refine import refine_matches_lk

    img = _lk_scene()[0][:96, :96].copy()
    pts = np.array([[48.0, 48.0], [5.0, 5.0]])
    for template in (np.zeros_like(img), img):  # a flat template; a textured one
        want, wmoved = refine_matches_lk(jnp.asarray(template), jnp.asarray(img),
                                         jnp.asarray(pts), jnp.asarray(pts))
        got, moved = PRF.refine_matches_lk(torch.from_numpy(template), torch.from_numpy(img),
                                           torch.from_numpy(pts), torch.from_numpy(pts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        np.testing.assert_allclose(moved.numpy(), np.asarray(wmoved), atol=1e-4)
        assert np.array_equal(got.numpy()[1], pts[1]) and (moved.numpy()[1] == 0).all()
    assert (moved.numpy()[0] == 0).all() or np.abs(moved.numpy()[0]).max() < 1e-3


# ---------------------------------------------------------------------------
# The stage and the slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_dim, want_factor", [(2048, 1), (160, 2)])
def test_match_for_geometry_learned_matches_reference(ref_v4, raw_pair, max_dim, want_factor):
    """Detection, matching and the full-resolution LK step have no random
    stream: the correspondences must agree, at full size (factor 1) and,
    as on a 4K pair, detected at half size with the coordinates scaled back
    and LK run on the full-resolution pair (factor 2). Each link is held at
    1e-3 px: the matches and their detected points against the reference's,
    and the LK-refined right points against the reference's LK run from the
    port's detected points. (The reference's 16 LK steps move a point by up
    to 6e-3 px when its left point moves by 1e-4 px, which is the size of
    the corner refinement's float32 noise; see _hold_features.) The
    reference runs op by op, as its geometry path does (under jax.jit one
    mutual near-tie of 4096 descriptors resolves the other way)."""
    import dataclasses

    from stereo_reconstruction_cv_tpu import config as RC
    from stereo_reconstruction_cv_tpu.ops.refine import refine_matches_lk
    from stereo_reconstruction_cv_tpu.pipeline import stages as RS

    imL, imR, _ = raw_pair
    cfg, pcfg = RC.DEFAULT.match, convert.pipeline_config(RC.DEFAULT).match
    p1, p2, mask, factor = RS._match_for_geometry(imL, imR, dataclasses.replace(cfg, lk_refine=False),
                                                  max_dim=max_dim, method="learned",
                                                  checkpoint=REF_CKPT)
    tL, tR = torch.from_numpy(imL.copy()), torch.from_numpy(imR.copy())
    u1, u2, umask, _ = stages._match_for_geometry(tL, tR, dataclasses.replace(pcfg, lk_refine=False),
                                                  max_dim=max_dim, method="learned")
    q1, q2, qmask, qfactor = stages._match_for_geometry(tL, tR, pcfg, max_dim=max_dim,
                                                        method="learned")
    mask = np.asarray(mask)
    assert qfactor == factor == want_factor and q1.dtype == q2.dtype == torch.float64
    np.testing.assert_array_equal(qmask.numpy(), mask)
    np.testing.assert_array_equal(umask.numpy(), mask)
    assert mask.sum() > 800 // want_factor**2
    assert np.abs(q1.numpy() - np.asarray(p1))[mask].max() <= 1e-3
    assert np.abs(u2.numpy() - np.asarray(p2))[mask].max() <= 1e-3
    want2, _ = refine_matches_lk(jnp.asarray(imL), jnp.asarray(imR), jnp.asarray(u1.numpy(), jnp.float32),
                                 jnp.asarray(u2.numpy(), jnp.float32), win=cfg.lk_win, iters=cfg.lk_iters)
    assert np.abs(q2.numpy() - np.asarray(want2))[mask].max() <= 1e-3


def test_config4_step_matches_reference(ref_v4, port_v4, raw_pair):
    """The reference's config 4 step (benchmarks.py:438-446): detect_pair ->
    match_learned -> gather_correspondences -> triangulate_points, on a crop
    of the raw pair with the rig's projection matrices."""
    from stereo_reconstruction_cv_tpu.ops import geometry as RG
    from stereo_reconstruction_cv_tpu.ops import matching as RM
    from stereo_reconstruction_cv_tpu_torch.ops import geometry as PG
    from stereo_reconstruction_cv_tpu_torch.ops import matching as PM

    model, params = ref_v4
    imL, imR, _ = raw_pair
    l, r = imL[40:176, 40:280], imR[40:176, 40:280]
    P1 = np.hstack([RAW_K, np.zeros((3, 1))]).astype(np.float32)
    P2 = np.hstack([RAW_K, (RAW_K @ RAW_T)[:, None]]).astype(np.float32)
    f1, f2 = ref_detect_pair(params, model, jnp.asarray(l), jnp.asarray(r), 256)
    res = RM.match_learned(f1.descriptors, f2.descriptors)
    q1, q2, w = RM.gather_correspondences(f1.keypoints, f2.keypoints, res)
    want = np.asarray(RG.triangulate_points(jnp.asarray(P1), jnp.asarray(P2), q1, q2))
    g1, g2 = PX.detect_pair(port_v4, torch.tensor(l), torch.tensor(r), 256)
    pres = PM.match_learned(g1.descriptors, g2.descriptors)
    p1, p2, v = PM.gather_correspondences(g1.keypoints, g2.keypoints, pres)
    got = PG.triangulate_points(torch.from_numpy(P1), torch.from_numpy(P2), p1, p2).numpy()
    w = np.asarray(w)
    np.testing.assert_array_equal(v.numpy(), w)
    assert w.sum() > 40
    # the corner refinement's float32 noise (see _hold_features), as in the
    # geometry stage's test
    assert np.abs(p1.numpy() - np.asarray(q1))[w].max() <= 1e-3
    assert np.abs(p2.numpy() - np.asarray(q2))[w].max() <= 1e-3
    # homogeneous points are defined up to sign: compare them dehomogenised
    X, Y = got[w, :3] / got[w, 3:], want[w, :3] / want[w, 3:]
    assert np.abs(X - Y).max() <= 1e-3 * np.abs(Y).max()


def test_estimate_geometry_learned_finds_the_rig(raw_pair):
    """Against the truth (the reference gives 0.70 and 0.41 degrees here; the
    random streams of the robust fits differ from JAX's)."""
    imL, imR, R_true = raw_pair
    marks = []
    g = stages.estimate_geometry((imL, imR), camera_matrix=RAW_K, method="learned",
                                 device="cpu", on_stage=marks.append)
    assert marks == ["detect", "match", "LK", "F", "E", "pose"]
    R, t = g["Rotation Matrix"], g["Translation Vector"].ravel()
    r_err = np.degrees(np.arccos(np.clip((np.trace(R @ R_true.T) - 1) / 2, -1, 1)))
    t_err = np.degrees(np.arccos(np.clip(t @ RAW_T / np.linalg.norm(RAW_T), -1, 1)))
    assert r_err < 1.5 and t_err < 3.0, (r_err, t_err)
    assert g["num_inliers_E"] > 0.5 * g["num_matches"] > 400


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.path.insert(0, str(ROOT))
    jax.config.update("jax_platforms", "cpu")
    arrays = export_xfeat_npz(sys.argv[1], sys.argv[2])
    print(f"wrote {len(arrays)} arrays, {sum(a.size for a in arrays.values())} parameters "
          f"-> {sys.argv[2]}")
