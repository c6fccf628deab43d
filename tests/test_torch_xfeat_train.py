"""Port vs JAX reference: XFeat training (losses, optimiser, stereo pool, verb).

JAX's random streams cannot be reproduced in torch, so the reference's
draws are read from its keys (``ref_draws`` splits them as its
``xfeat_loss`` and ``random_homography`` do) and fed to the port's pure
functions. The reference runs in float32 (``jax.enable_x64(False)``, as it
trains; this suite's conftest turns x64 on) and under ``jax.jit`` (one
compile a loss, ~5 s, where op by op takes ~35 s); torch runs on one thread.
Both start from the shipped v4 weights, converted. Tolerances, each stated
where it is checked: the losses to 1e-5 relative, every gradient tensor to
1e-4 of its largest entry, the optimiser's updates to 5e-5 relative, the
parameters after two steps by chip_smoke.py's move_error, the homography to
1e-6 of its largest entry, the stereo pool's disparity and mask bit-equal.
Harris targets are equal but where the two responses tie (the port sums
its blurs in float64, the reference in float32).
"""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from stereo_reconstruction_cv_tpu.config import SGBMConfig as RefSGBMConfig
from stereo_reconstruction_cv_tpu.models import xfeat as RX
from stereo_reconstruction_cv_tpu.models import xfeat_train as RXT
from stereo_reconstruction_cv_tpu.ops import disparity as RDP
from stereo_reconstruction_cv_tpu_torch import cli, convert
from stereo_reconstruction_cv_tpu_torch.io.image import save_image
from stereo_reconstruction_cv_tpu_torch.models import checkpoint as CKPT
from stereo_reconstruction_cv_tpu_torch.models import xfeat as PX
from stereo_reconstruction_cv_tpu_torch.models import xfeat_train as PXT
from stereo_reconstruction_cv_tpu_torch.tools import xfeat_warpcheck
from stereo_reconstruction_cv_tpu_torch.utils import synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 2, 64, 96
LOSS_RTOL = 1e-5   # a loss's value, relative
GRAD_TOL = 1e-4    # a gradient tensor's largest error over its largest entry
# An optimiser update, relative to its largest entry: optax forms Adam's bias
# corrections 1 - b^t in float32 (1 - 0.999^2 carries a relative error of
# 1.3e-5), torch.optim.Adam in float64.
STEP_RTOL = 5e-5
K_SMALL = synth.K_4K * np.array([[0.03], [0.03], [1.0]])  # 115 px focal length


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_v4():
    with np.load(CKPT.default_checkpoint()) as z:
        return {k: z[k] for k in z.files}


def _port_model():
    """The port's net with the v4 weights, trainable."""
    model = PX.XFeatNet()
    model.load_state_dict(convert.xfeat_state_dict(_flat_v4()))
    return model


def _grads_as_port(tree) -> dict:
    """A flax gradient tree -> the port's state_dict names and layouts."""
    return convert.xfeat_state_dict({"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()})


@pytest.fixture(scope="module")
def ref():
    """The reference's net, the v4 parameters and its jitted float32 value
    and gradient of both losses."""
    model = RX.XFeatNet()
    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in _flat_v4().items()})
    homog = jax.jit(jax.value_and_grad(lambda p, i, k: RX.xfeat_loss(p, model, i, k)))
    stereo = jax.jit(jax.value_and_grad(
        lambda p, a, b, d, v: RX.xfeat_stereo_loss(p, model, a, b, d, v)))
    return model, params, homog, stereo


def ref_draws(key, batch: int) -> PX.WarpDraws:
    """The draws the reference's xfeat_loss makes from `key` (its splits,
    in float32), as the port's WarpDraws."""
    with jax.enable_x64(False):
        allk = jax.random.split(key, batch + 2)
        rows = []
        for k in allk[:batch]:
            k1, k2, k3 = jax.random.split(k, 3)
            rows.append((jax.random.uniform(k1, (4, 2), minval=-0.15, maxval=0.15, dtype=jnp.float32),
                         jax.random.uniform(k2, (), minval=-0.35, maxval=0.35, dtype=jnp.float32),
                         jax.random.uniform(k3, (), minval=0.75, maxval=1.25, dtype=jnp.float32)))
        gain = jax.random.uniform(allk[batch], (batch, 1, 1), minval=0.75, maxval=1.3)
        bias = jax.random.uniform(allk[batch + 1], (batch, 1, 1), minval=-18.0, maxval=18.0)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))
    return PX.WarpDraws(*(t(np.stack([r[i] for r in rows])) for i in range(3)), t(gain), t(bias))


def _images(batch=B, h=H, w=W, seed=0):
    """Rendered scene views (textured planes), float32 in [0, 255]."""
    return np.stack([synth.render_pair(K_SMALL, np.eye(3), np.array([-0.14, 0.0, 0.0]), h, w,
                                       seed=seed + s)[0].numpy() for s in range(batch)]
                    ).astype(np.float32)


def _stereo_inputs():
    """Rectified rendered crops (B, H, W) with the port's SGBM labels."""
    quads = []
    for s in range(B):
        left, right = synth.render_pair(K_SMALL, np.eye(3), np.array([-0.14, 0.0, 0.0]), H, W,
                                        seed=10 + s)
        quads.append(PXT.stereo_labels(left, right, width=W, ndisp=16))
    L, R, D, V = (np.stack([q[i].numpy() for q in quads]) for i in range(4))
    return L, R, D, V > 0.5


@functools.lru_cache(maxsize=None)
def _smoke():
    """chip_smoke.py as a module (its move_error and tolerances)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _hold_grads(model, ref_grads):
    for name, p in model.named_parameters():
        want = ref_grads[name]
        err = float((p.grad - want).abs().max() / want.abs().max())
        assert err <= GRAD_TOL, (name, err)


# ---------------------------------------------------------------------------
# Homography, warp, Harris targets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
def test_homography_from_draws_matches_reference(seed):
    key = jax.random.PRNGKey(seed)
    d = ref_draws(key, 3)
    got = PX.homography_from_draws(d.shift, d.angle, d.scale, H, W)
    with jax.enable_x64(False):
        keys = jax.random.split(key, 5)[:3]
        want = np.stack([np.asarray(RX.random_homography(k, H, W)) for k in keys])
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3)
    # float32 8x8 solves by two LAPACK calls: within 1e-6 of the largest entry
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    single = PX.homography_from_draws(d.shift[1], d.angle[1], d.scale[1], H, W)
    torch.testing.assert_close(single, got[1], rtol=0, atol=0)


def test_warp_image_matches_reference():
    imgs = _images()
    d = ref_draws(jax.random.PRNGKey(3), B)
    Hms = PX.homography_from_draws(d.shift, d.angle, d.scale, H, W)
    got = PX.warp_image(torch.from_numpy(imgs), Hms)
    cover = PX.warp_image(torch.ones(B, H, W), Hms)
    with jax.enable_x64(False):
        want = np.stack([np.asarray(RX.warp_image(jnp.asarray(imgs[i]), jnp.asarray(Hms[i].numpy())))
                         for i in range(B)])
        want_cover = np.stack([np.asarray(RX.warp_image(jnp.ones((H, W), jnp.float32),
                                                        jnp.asarray(Hms[i].numpy())))
                               for i in range(B)])
    # The inverse and the division differ by ~1 ulp: float32 source
    # coordinates below 100 px move by up to 2e-5 px, and a bilinear value by
    # at most its image's step a pixel (255 grey levels; 1 for the coverage)
    # times that (a coordinate on an integer can floor either way; the
    # interpolation is continuous there).
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=255 * 2e-5)
    np.testing.assert_allclose(cover.numpy(), want_cover, rtol=0, atol=2e-5)
    assert (want == 0).any()  # the warp left the image: the zero border is checked
    torch.testing.assert_close(PX.warp_image(torch.from_numpy(imgs[1]), Hms[1]), got[1],
                               rtol=0, atol=0)


def test_harris_targets_match_reference_except_at_ties():
    imgs = np.concatenate([_images(seed=4), np.zeros((1, H, W), np.float32)])
    imgs[2, 16:, 16:] = 200.0  # the reference's one-corner image, and flat cells
    got, resp = PX.harris_cell_targets(torch.from_numpy(imgs))
    want, want_resp = (np.asarray(a) for a in RX.harris_cell_targets(jnp.asarray(imgs)))
    scale = np.abs(want_resp).max(axis=(1, 2), keepdims=True)
    # float64 blur sums against float32 (jnp.convolve): the responses agree
    # to 1e-5 of each image's largest
    assert (np.abs(resp.numpy() - want_resp) <= 1e-5 * scale).all()
    got = got.numpy()
    Hc, Wc = H // PX.CELL, W // PX.CELL
    cells = want_resp.reshape(3, Hc, PX.CELL, Wc, PX.CELL).transpose(0, 1, 3, 2, 4).reshape(3, Hc, Wc, 64)
    for b, i, j in zip(*np.nonzero(got != want)):
        # A tie: both picks within 1e-5 of the image's largest response of
        # each other, or the cell's maximum that close to the dustbin
        # threshold.
        tol = 1e-5 * scale[b, 0, 0]
        thr = 0.02 * cells[b].max()
        c = cells[b, i, j]
        picks = [c[t] if t < 64 else thr for t in (got[b, i, j], want[b, i, j])]
        assert abs(picks[0] - picks[1]) <= tol or abs(c.max() - thr) <= tol, (b, i, j)
    assert (got != want).mean() <= 0.02
    assert got[2, 2, 2] != 64 and got[2, 0, 0] == 64


# ---------------------------------------------------------------------------
# The losses and their gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bank", [True, False])
def test_cells_loss_matches_reference(bank):
    rng = np.random.default_rng(1)
    Hc, Wc, D = 6, 8, 16
    da = rng.normal(size=(B, Hc, Wc, D)).astype(np.float32)
    da /= np.linalg.norm(da, axis=-1, keepdims=True)
    db = (da + 0.3 * rng.normal(size=da.shape)).astype(np.float32)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    la, lb = (rng.normal(size=(B, Hc, Wc, 65)).astype(np.float32) for _ in range(2))
    ra = rng.uniform(size=(B, Hc, Wc)).astype(np.float32)
    centers = np.asarray(RX._cell_centers(Hc, Wc), np.float32)
    # cells shifted by about one to the left, some leaving the grid
    pb = (centers[None] + rng.uniform(-12.0, 3.0, size=(B, Hc, Wc, 2))).astype(np.float32)
    valid = rng.uniform(size=(B, Hc, Wc)) > 0.2
    got = PX._cells_loss(*(torch.from_numpy(a) for a in (da, db, la, lb, ra, pb, valid)), bank=bank)
    bank_arr = jnp.asarray(db.reshape(B * Hc * Wc, D)) if bank else None
    with jax.enable_x64(False):
        want = np.array([float(RX._cells_loss(*(jnp.asarray(a[i]) for a in (da, db, la, lb, ra, pb, valid)),
                                              bank=bank_arr, bank_offset=i * Hc * Wc if bank else 0))
                         for i in range(B)])
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL)


def test_xfeat_loss_and_gradients_match_reference(ref):
    _, params, homog, _ = ref
    imgs = _images()
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(False):
        want, grads = homog(params, jnp.asarray(imgs), key)
    model = _port_model()
    loss = PX.xfeat_loss(model, torch.from_numpy(imgs), ref_draws(key, B))
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= LOSS_RTOL * abs(float(want))
    _hold_grads(model, _grads_as_port(grads))


def test_xfeat_stereo_loss_and_gradients_match_reference(ref):
    _, params, _, stereo = ref
    L, R, D, V = _stereo_inputs()
    assert 0.3 < V.mean() < 1.0
    with jax.enable_x64(False):
        want, grads = stereo(params, *(jnp.asarray(a) for a in (L, R, D, V)))
    model = _port_model()
    loss = PX.xfeat_stereo_loss(model, *(torch.from_numpy(a) for a in (L, R, D, V)))
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= LOSS_RTOL * abs(float(want))
    _hold_grads(model, _grads_as_port(grads))


# ---------------------------------------------------------------------------
# The optimiser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lr,warmup,steps", [(2e-3, 200, 5000), (1e-3, 10, 300), (2e-3, 200, 3),
                                             (5e-4, 0, 50)])
def test_warmup_cosine_matches_optax(lr, warmup, steps):
    got = PXT.warmup_cosine(lr, warmup, steps)
    counts = sorted({0, 1, 2, warmup - 1, warmup, warmup + 1, steps // 2, steps - 1, steps} - {-1})
    if steps > warmup:
        want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps)
    else:  # optax refuses a schedule with no decay steps; the warmup alone
        with pytest.raises(ValueError):
            optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps)
        want = optax.linear_schedule(0.0, lr, warmup)
        counts = [c for c in counts if c < steps]
    for c in counts:
        assert got(c) == pytest.approx(float(want(c)), rel=1e-6, abs=1e-12), c
    assert got(0) == 0.0 or warmup == 0


def _optax_chain(lr, warmup, steps):
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adam(optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps)))


def test_optimizer_steps_match_optax_chain():
    """Three updates from fixed gradients: step 0 (lr 0: parameters
    unchanged, moments updated), a global norm below 1 (no clip) and one
    above it (clipped)."""
    model = _port_model()
    names = [n for n, _ in model.named_parameters()]
    rng = np.random.default_rng(2)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    draws = [{n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()} for _ in range(3)]
    for g, norm in zip(draws, (3.0, 0.5, 4.0)):
        total = np.sqrt(sum((a.astype(np.float64) ** 2).sum() for a in g.values()))
        for n in g:
            g[n] *= np.float32(norm / total)
    state = PX.create_train_state(model, PXT.warmup_cosine(1e-2, 2, 10), max_norm=1.0)
    tx = _optax_chain(1e-2, 2, 10)
    sd = model.state_dict()
    flat_names = {v: k for k, v in convert._xfeat_names().items()}
    jparams = {flat_names[n]: jnp.asarray(sd[n].numpy().transpose(2, 3, 1, 0) if sd[n].dim() == 4
                                          else sd[n].numpy()) for n in names}
    update = jax.jit(tx.update)
    with jax.enable_x64(False):
        opt_state = tx.init(jparams)
        for k, g in enumerate(draws):
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            for n, p in model.named_parameters():
                p.grad = torch.from_numpy(g[n].copy())
            norm_before = float(np.sqrt(sum((a.astype(np.float64) ** 2).sum() for a in g.values())))
            PX.apply_gradients(state)
            jg = {flat_names[n]: jnp.asarray(g[n].transpose(2, 3, 1, 0) if g[n].ndim == 4 else g[n])
                  for n in names}
            updates, opt_state = update(jg, opt_state, jparams)
            want = convert.xfeat_state_dict({k_: np.asarray(v) for k_, v in updates.items()})
            for n, p in model.named_parameters():
                step = (p.detach() - before[n])
                if k == 0:
                    assert torch.equal(step, torch.zeros_like(step)), n
                    assert not np.any(np.asarray(want[n]))
                else:
                    err = float((step - want[n]).abs().max() / want[n].abs().max())
                    assert err <= STEP_RTOL, (k, n, err)
            # apply_gradients clipped the gradients in place
            clipped = PX.clip_by_global_norm_(list(model.parameters()), 1.0)
            assert float(clipped) == pytest.approx(min(norm_before, 1.0), rel=1e-5)
    assert state.step == 3


def test_two_train_steps_match_reference(ref):
    """Loss and gradients of two train_steps and the parameters after them
    against the reference's value_and_grad and optax's chain (lr 0 at step
    0, 1e-3 at step 1)."""
    _, params, homog, _ = ref
    imgs = _images(seed=20)
    tx = _optax_chain(1e-3, 1, 10)
    model = _port_model()
    state = PX.create_train_state(model, PXT.warmup_cosine(1e-3, 1, 10), max_norm=1.0)
    keys = [jax.random.PRNGKey(30 + k) for k in range(2)]
    ref_grads = []
    with jax.enable_x64(False):
        opt_state = tx.init(params)
        for key in keys:
            want, grads = homog(params, jnp.asarray(imgs), key)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            ref_grads.append(_grads_as_port(grads))
            loss = PX.train_step(state, torch.from_numpy(imgs), ref_draws(key, B))
            assert abs(float(loss) - float(want)) <= LOSS_RTOL * abs(float(want))
            # the clipped gradients: the norm was above 1 at both steps
            clip = torch.sqrt(sum((g * g).sum() for g in ref_grads[-1].values()))
            assert float(clip) > 1.0
            for name, p in model.named_parameters():
                want_g = ref_grads[-1][name] / clip
                assert float((p.grad - want_g).abs().max() / want_g.abs().max()) <= GRAD_TOL, name
    # chip_smoke.py's move_error: Adam moves an entry whose gradient is near
    # zero by up to the lr whatever the gradient's error
    err, share, err_all = _smoke().move_error({n: p.detach() for n, p in model.named_parameters()},
                                              _grads_as_port(params), ref_grads, 1e-3)
    assert err <= _smoke().TRAIN_MOVE_TOL and share > 1 / 3 and err_all <= 2.0, (err, share, err_all)


# ---------------------------------------------------------------------------
# Initialisation and the checkpoint
# ---------------------------------------------------------------------------

def test_init_params_draws_flax_lecun_normal():
    model = PX.init_params(PX.XFeatNet(), torch.Generator().manual_seed(0))
    again = PX.init_params(PX.XFeatNet(), torch.Generator().manual_seed(0))
    other = PX.init_params(PX.XFeatNet(), torch.Generator().manual_seed(1))
    ref_params = jax.jit(RX.XFeatNet().init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 1), jnp.float32))
    ref_sd = _grads_as_port(ref_params)
    for name, p in model.state_dict().items():
        assert torch.equal(p, again.state_dict()[name])
        if name.endswith("bias"):
            assert torch.equal(p, torch.zeros_like(p)), name
            continue
        if ".norm." in name:
            assert torch.equal(p, torch.ones_like(p)), name
            continue
        assert not torch.equal(p, other.state_dict()[name])
        fan_in = p[0].numel()
        std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert float(p.abs().max()) <= 2.0 * std * (1 + 1e-6), name
        # the sample's std within 4 standard errors of sqrt(1 / fan_in), as
        # flax's own draw of the same layer
        se = 4.0 / np.sqrt(2.0 * p.numel())
        for w in (p, ref_sd[name]):
            assert abs(float(w.double().std()) * np.sqrt(fan_in) - 1.0) <= se, name
            assert abs(float(w.double().mean()) * np.sqrt(fan_in)) <= 4.0 / np.sqrt(p.numel()), name


def test_save_params_round_trip(tmp_path):
    model = PX.init_params(PX.XFeatNet(), torch.Generator().manual_seed(3))
    path = CKPT.save_params(str(tmp_path / "sub" / "w"), model)
    assert path.endswith("w.npz") and os.path.exists(path)
    with np.load(path) as z, np.load(CKPT.default_checkpoint()) as v4:
        assert sorted(z.files) == sorted(v4.files)
        assert all(z[k].shape == v4[k].shape and z[k].dtype == np.float32 for k in z.files)
    loaded = CKPT.load_params(path, "cpu")
    for name, p in model.state_dict().items():
        assert torch.equal(loaded[name], p), name
    v4 = CKPT.load_model(CKPT.default_checkpoint(), "cpu")
    flat = convert.xfeat_flat_params(v4.state_dict())
    for k, v in _flat_v4().items():
        np.testing.assert_array_equal(flat[k], v)


# ---------------------------------------------------------------------------
# Data, the stereo pool, training, the verb
# ---------------------------------------------------------------------------

def _jpeg_folder(folder, n=3, h=120, w=200):
    os.makedirs(folder, exist_ok=True)
    for s in range(n):
        save_image(os.path.join(folder, f"v{s}.jpg"), _images(1, h, w, seed=40 + s)[0].astype(np.uint8),
                   quality=95)
    return str(folder)


def test_load_training_images_matches_reference(tmp_path):
    folder = _jpeg_folder(tmp_path / "imgs", n=2, h=120, w=200)
    for kw in ({}, {"max_side": 64}, {"max_side": 90, "max_images": 1}):
        got = PXT.load_training_images([folder], **kw)
        want = RXT.load_training_images([folder], **kw)
        assert len(got) == len(want) > 0
        for g, w_ in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w_.shape
            np.testing.assert_array_equal(g, w_)


def test_stereo_labels_match_reference():
    """The pool's downscale + SGBM (64 disparities, 5 paths) of one
    rectified pair, the reference's lines inline: bit-equal."""
    left, right = synth.render_pair(K_SMALL * np.array([[2.0], [2.0], [1.0]]), np.eye(3),
                                    np.array([-0.14, 0.0, 0.0]), 100, 260, seed=3)
    got = PXT.stereo_labels(left, right, width=128, ndisp=64)
    rl, rr = left.numpy(), right.numpy()
    h, w = rl.shape
    k = int(np.ceil(w / 128))
    assert k == 3
    rl = rl[: h - h % k, : w - w % k].reshape(h // k, k, -1, k).mean((1, 3))
    rr = rr[: h - h % k, : w - w % k].reshape(h // k, k, -1, k).mean((1, 3))
    cfg = RefSGBMConfig(num_disparities=64, num_directions=5)
    dsp, val = RDP.sgbm_disparity(jnp.asarray(np.clip(rl, 0, 255).astype(np.uint8)),
                                  jnp.asarray(np.clip(rr, 0, 255).astype(np.uint8)), cfg)
    want = (rl.astype(np.float32), rr.astype(np.float32), np.asarray(dsp, np.float32),
            np.asarray(val).astype(np.float32))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_)
    assert 0.2 < want[3].mean() < 1.0


def test_batches_are_aligned_crops_of_the_pool():
    gen = torch.Generator().manual_seed(0)
    pool = torch.arange(3 * 40 * 50, dtype=torch.float32).reshape(3, 40, 50) % 251
    crops = PXT._device_batch(pool, gen, 4, 16)
    assert crops.shape == (4, 16, 16) and float(crops.min()) >= 0 and float(crops.max()) <= 255
    again = PXT._device_batch(pool, torch.Generator().manual_seed(0), 4, 16)
    assert torch.equal(crops, again)
    L = torch.rand(2, 30, 40, generator=gen) * 255
    spool = (L, L + 1, torch.arange(2 * 30 * 40, dtype=torch.float32).reshape(2, 30, 40),
             (torch.rand(2, 30, 40, generator=gen) > 0.5).float())
    cl, cr, cd, cv = PXT._stereo_batch(spool, gen, 3, 8)
    assert cl.shape == cr.shape == cd.shape == cv.shape == (3, 8, 8) and cv.dtype == torch.bool
    # every crop of D is one contiguous window: origin from its first entry
    for i in range(3):
        n, rem = divmod(int(cd[i, 0, 0]), 30 * 40)
        y, x = divmod(rem, 40)
        assert torch.equal(cd[i], spool[2][n, y:y + 8, x:x + 8])
        assert torch.equal(cv[i], spool[3][n, y:y + 8, x:x + 8] > 0.5)


def test_loss_decreases():
    """The reference's criterion (tests/test_xfeat.py:87): 30 steps of Adam
    at 1e-3 from a fresh init on a textured 4 x 64 x 96 batch; the last loss
    below 0.8 of the first. One run of it is a coin flip for either
    implementation (reference fault C.11): the reference passes it at its
    own seeds (init key 1, step keys from 2) and fails it at others. So both
    run it at three seeds, the reference with keys (s, s + 1) and the port
    with generators seeded alike; each of the port's runs must be finite and
    fall, and the mean of its three ratios must be no worse than the
    reference's: the port learns at least as fast as the reference on the
    reference's task."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, size=(4, 64, 96)).astype(np.float32)
    imgs = np.stack([ndi.gaussian_filter(i, 2.0) * 4 % 255 for i in imgs])
    seeds = (1, 2, 3)
    ref_ratios = []
    with jax.enable_x64(False):
        model, tx = RX.XFeatNet(), optax.adam(1e-3)  # create_train_state's optimiser
        step = jax.jit(lambda s, i, k: RX.train_step(s, tx, model, i, k))
        imgs_j = jnp.asarray(imgs)
        for seed in seeds:
            state, _ = RX.create_train_state(jax.random.PRNGKey(seed), model, (64, 96))
            key, losses = jax.random.PRNGKey(seed + 1), []
            for _ in range(30):
                key, sub = jax.random.split(key)
                state, loss = step(state, imgs_j, sub)
                losses.append(float(loss))
            ref_ratios.append(losses[-1] / losses[0])
    ratios = []
    for seed in seeds:
        model = PX.init_params(PX.XFeatNet(), torch.Generator().manual_seed(seed))
        state = PX.create_train_state(model, 1e-3)
        gen = torch.Generator().manual_seed(seed + 1)
        losses = [float(PX.train_step(state, torch.from_numpy(imgs), PX.draw_warps(gen, 4)))
                  for _ in range(30)]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses[::10]
        ratios.append(losses[-1] / losses[0])
    assert np.mean(ratios) <= np.mean(ref_ratios), (ratios, ref_ratios)


def test_train_and_the_verb_write_weights_match_serves(tmp_path):
    folder = _jpeg_folder(tmp_path / "imgs")
    hist = PXT.train([folder], steps=4, batch=2, crop=64, output=str(tmp_path / "t" / "w"),
                     log_every=2, device="cpu")
    seen = []
    hist2 = PXT.train([folder], steps=3, batch=2, crop=64, output=str(tmp_path / "t2.npz"),
                      log_every=100, device="cpu", on_step=lambda it, loss: seen.append(it))
    assert [h[0] for h in hist] == [0, 2, 3] and [h[0] for h in hist2] == [0, 2]
    assert seen == [0, 1, 2] and all(np.isfinite(v) for _, v in hist + hist2)
    assert hist2[0] == hist[0]  # the same seed: the same init and draws
    assert os.path.exists(tmp_path / "t" / "w.npz")

    out = tmp_path / "cli_w"
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = subprocess.run([sys.executable, "-m", "stereo_reconstruction_cv_tpu_torch.cli",
                          "train-features", folder, "--steps", "3", "--size", "64", "--batch", "2",
                          "--device", "cpu", "--output", str(out)],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert run.returncode == 0, run.stderr
    assert f"saved checkpoint to {out}.npz" in run.stdout
    pair = tmp_path / "pair"
    pair.mkdir()
    left, right = synth.render_pair(K_SMALL * np.array([[2.0], [2.0], [1.0]]), np.eye(3),
                                    np.array([-0.14, 0.0, 0.0]), 120, 160, seed=5)
    save_image(str(pair / "img1.jpg"), left.numpy(), quality=95)
    save_image(str(pair / "img2.jpg"), right.numpy(), quality=95)
    assert cli.main(["match", str(pair), "--learned", "--model", f"{out}.npz", "--device",
                     "cpu"]) == 0


def test_train_features_without_folders_exits_1(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the default folders, under reference/, are absent
    assert cli.main(["train-features", "--steps", "1", "--device", "cpu"]) == 1
    assert "no *.jpg" in capsys.readouterr().err
    assert PXT.build_stereo_pool(device="cpu", cache_dir=str(tmp_path)) is None


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs")
    folder = _jpeg_folder(tmp_path / "imgs", n=1)
    with pytest.raises(RuntimeError, match="cuda"):
        PXT.train([folder], steps=1, batch=2, crop=64, output=str(tmp_path / "w"))
    with pytest.raises(RuntimeError, match="cuda"):
        PXT.build_stereo_pool([folder], cache_dir=str(tmp_path))
    assert not os.path.exists(tmp_path / "w.npz")


def test_stereo_pool_and_stereo_training_on_the_cpu(tmp_path, monkeypatch):
    """Two rendered raw pairs (img1.jpg / img2.jpg) -> rectify_pair ->
    stereo_labels, cached; then a stereo step from the v4 weights. The
    pairs are rendered at 3/40 of the 4K rig, with its K scaled alike."""
    K = synth.K_4K * np.array([[0.075], [0.075], [1.0]])
    monkeypatch.setattr(PXT, "POOL_K", K)
    R = synth.rotation_about((0.2, 1.0, 0.1), 2.0)
    pairs = []
    for s in range(2):
        left, right = synth.render_pair(K, R, np.array([-0.14, 0.004, -0.003]), 162, 288, seed=s)
        folder = tmp_path / f"pair{s}"
        folder.mkdir()
        save_image(str(folder / "img1.jpg"), left.numpy(), quality=95)
        save_image(str(folder / "img2.jpg"), right.numpy(), quality=95)
        pairs.append(str(folder))
    pool = PXT.build_stereo_pool(pairs, width=144, ndisp=16, cache_dir=str(tmp_path), device="cpu")
    assert len(pool) == 4 and pool[0].shape[0] == 2 and pool[0].shape[2] <= 144
    assert os.path.exists(tmp_path / "stereo_pool_144_16.npz")
    assert 0.2 < float(pool[3].mean()) <= 1.0
    again = PXT.build_stereo_pool(pairs, width=144, ndisp=16, cache_dir=str(tmp_path), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(pool, again))
    model = _port_model()
    state = PX.create_train_state(model, 1e-4, max_norm=1.0)
    gen = torch.Generator().manual_seed(0)
    imgs = torch.from_numpy(_images(seed=50))
    loss = PX.train_step(state, imgs, PX.draw_warps(gen, B), PXT._stereo_batch(pool, gen, B, 64))
    assert np.isfinite(float(loss)) and state.step == 1


def test_warp_true_rate_matches_reference(ref):
    """The port's warp check against the reference tool's body on the same
    rendered image and homographies (the reference's detect, jitted, with the
    v4 weights, under "highest" matmul precision)."""
    from stereo_reconstruction_cv_tpu.ops import matching as RM

    model, params, _, _ = ref
    detect = jax.jit(lambda p, im: RX.detect(p, model, im, 1024))
    img = xfeat_warpcheck.rendered_image(240, 320, device="cpu")
    seeds = (3, 4)
    got = xfeat_warpcheck.warp_true_rate(CKPT.default_checkpoint(), img, seeds=seeds,
                                         max_kpts=1024, device="cpu")
    imgn = img.numpy().astype(np.float32)
    want = []
    for seed in seeds:
        Hm = PX.random_homography(torch.Generator().manual_seed(seed), 240, 320).numpy()
        with jax.enable_x64(False):
            warped = np.asarray(RX.warp_image(jnp.asarray(imgn), jnp.asarray(Hm)))
            with jax.default_matmul_precision("highest"):
                fl, fr = (detect(params, jnp.asarray(a.astype(np.uint8))) for a in (imgn, warped))
                mres = RM.match_learned(fl.descriptors, fr.descriptors, fl.mask, fr.mask,
                                        min_cossim=0.5)
        p1, p2, mask = (np.asarray(a) for a in RM.gather_correspondences(fl.keypoints, fr.keypoints,
                                                                          mres))
        ph = np.concatenate([p1, np.ones((len(p1), 1))], 1) @ Hm.T
        err = np.linalg.norm(ph[:, :2] / ph[:, 2:3] - p2, axis=1)
        want.append(((err[mask] < 3).mean(), int(mask.sum())))
    # A keypoint that differs (detection agrees to 1e-3 px,
    # tests/test_torch_xfeat.py) moves a match or two.
    for (rate, n), (want_rate, want_n) in zip(got, want):
        assert n > 100 and abs(n - want_n) <= 0.01 * want_n and abs(rate - want_rate) <= 0.01, (got, want)
