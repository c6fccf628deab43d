"""Port vs JAX reference: the standalone WTA pass and the probes' variants.

The plain ``wta_volume`` and ``wta_packed`` (CPU tensors) are held bit for
bit, all four fields and the f32 disparity included, against
``sgm_pallas._wta_volume(..., interpret=True)`` and against
``tools/micro_wta.py``'s ``wta_nat`` and ``wta_variant`` (extraction by dot
and by butterfly) run under ``pltpu.force_tpu_interpret_mode()``. The
reference's butterfly sum is exact only where D is a power of two (at other
D its wrapped rolls count some lanes twice), so the butterfly variant is
compared where D is one; the port's masked warp sum is exact at every D and
is held to ``_wta_volume`` there.
"""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stereo_reconstruction_cv_tpu.ops.pallas import sgm_pallas as SP
from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK

ROOT = pathlib.Path(__file__).resolve().parent.parent
P1, P2 = 8 * 3 * 121, 32 * 3 * 121
Wc, H = 9, 130  # ragged against the probes' (8, 128) and (8, 512) tiles
CACHE_SETTINGS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def micro_wta():
    """tools/micro_wta.py imported by path. It sets two compilation-cache
    options and sys.path at import; both are put back."""
    saved = {k: getattr(jax.config, k) for k in CACHE_SETTINGS}
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("_reference_micro_wta",
                                                  ROOT / "tools" / "micro_wta.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


def _inputs(seed, D, nv, hi):
    rng = np.random.default_rng(seed)
    C = rng.integers(0, hi[0], (Wc, H, D)).astype(np.int16)
    ds = [rng.integers(0, hi[1], (Wc, H, D)).astype(np.uint16) for _ in range(nv)]
    return C, ds


def _port(C, ds):
    return torch.from_numpy(C), [torch.from_numpy(d.view(np.int16)) for d in ds]


@pytest.mark.parametrize("D,nv,ur,md,hi", [
    pytest.param(16, 1, 10, 0, (20000, 40000), id="D16-1vol"),
    pytest.param(16, 2, 0, 3, (6, 12), id="D16-2vol-narrow-ur0-md3"),
    pytest.param(24, 1, 10, 3, (6, 12), id="D24-1vol-narrow-md3"),
    pytest.param(24, 2, 10, 0, (20000, 40000), id="D24-2vol"),
    pytest.param(256, 1, 0, 0, (20000, 40000), id="D256-1vol-ur0"),
    pytest.param(256, 2, 10, 3, (6, 12), id="D256-2vol-narrow-md3"),
])
def test_wta_matches_reference_and_probes(micro_wta, D, nv, ur, md, hi):
    C, ds = _inputs(D * 10 + nv, D, nv, hi)
    Cj, dsj = jnp.asarray(C), [jnp.asarray(d) for d in ds]
    ref = [np.array(a) for a in SP._wta_volume(Cj, dsj, ur, md, interpret=True)]
    Ct, dst = _port(C, ds)
    got = [a.numpy() for a in SK.wta_volume(Ct, dst, ur, md)]
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if hi[0] < 100 and ur:  # the narrow range makes ties and uniqueness hits
        assert 0 < got[1].mean() < 1
    packed = SK.wta_packed(Ct, dst, ur, md).numpy()
    np.testing.assert_array_equal(packed, SK.pack_maps(*map(torch.from_numpy, ref)).numpy())
    with pltpu.force_tpu_interpret_mode():
        probes = {"nat": micro_wta.wta_nat(Cj, dsj, ur, md, 8, 512),
                  "dot": micro_wta.wta_variant(Cj, dsj, ur, md, 8, 128, True)}
        if D & (D - 1) == 0:
            probes["bfly"] = micro_wta.wta_variant(Cj, dsj, ur, md, 8, 128, False)
    for name, out in probes.items():
        np.testing.assert_array_equal(packed, np.asarray(out)[:Wc, :H], err_msg=name)
    for red in SK.REDUCTIONS:  # the knobs change no bit
        for ext in SK.EXTRACTS:
            np.testing.assert_array_equal(
                SK.wta_packed(Ct, dst, ur, md, 3, 7, red, ext).numpy(), packed)


@pytest.mark.parametrize("nd", [5, 8])
def test_fused_sweep_equals_standalone_pass_of_accumulated_deltas(nd):
    """sgm_pallas's docstring identity, on the plain versions: the last
    sweep fused with WTA equals the standalone WTA once that sweep's deltas
    are added to the last delta volume (5 paths: the only one; 8 paths: B)."""
    C = torch.from_numpy(np.random.default_rng(nd).integers(0, 3000, (11, 23, 24)).astype(np.int16))
    vols = [sum(SK.path_delta_plain(C, dx, dy, P1, P2) for dx, dy in g)
            for g in SK.delta_groups(nd) if g]
    fused = SK.sweep_wta_plain(C, sum(vols), nd, P1, P2, 10, 2)
    vols[-1] = vols[-1] + SK.path_delta_plain(C, *SK.FUSED_DIR, P1, P2)
    assert int(vols[-1].max()) <= 0xFFFF  # 5 directions fit u16 at the default P2
    as_u16 = [v.to(torch.int16) for v in vols]  # u16 bits in int16, as the kernels hold them
    alone = SK.wta_volume(C, as_u16, 10, 2)
    for a, b in zip(fused, alone):
        assert torch.equal(a, b)
    assert alone[1].any() and not alone[1].all()


def test_wta_argument_checks():
    C = torch.zeros((3, 4, 16), dtype=torch.int16)
    with pytest.raises(ValueError, match="one or two"):  # no volume is wta_volume's alone
        SK.wta_packed(C, [])
    with pytest.raises(ValueError, match="at most two"):
        SK.wta_volume(C, [C, C, C])
    with pytest.raises(ValueError, match="shape"):
        SK.wta_volume(C, [C[:, :2]])
    with pytest.raises(ValueError, match="int16"):
        SK.wta_volume(C.to(torch.int32), [C])
    with pytest.raises(ValueError, match="uniqueness"):
        SK.wta_volume(C, [C], uniqueness_ratio=101)
    with pytest.raises(ValueError, match="reduction"):
        SK.wta_packed(C, [C], reduction="tree")
    with pytest.raises(ValueError, match="tile"):
        SK.wta_packed(C, [C], bh=0)
    with pytest.raises(ValueError, match="CUDA"):
        SK._launch_wta(C, [C], 5, 10, 0, 1, 1, False, False, (None,) * 5)


def test_tool_variants_and_refusal_without_a_card(monkeypatch, capsys):
    """The port's micro_wta: every variant name of the reference's tool maps
    to a call with the same output; without a CUDA device main() exits 2."""
    from stereo_reconstruction_cv_tpu_torch.tools import micro_wta as tool

    C, ds = _port(*_inputs(5, 24, 1, (6, 12)))
    want = SK.wta_packed_plain(C, ds, tool.UNIQUENESS, tool.MIN_DISP)
    names = ["shipped", "shipped2", "nat", "2nat", "nat:4:64", "2nat:8:128",
             "8:128:dot", "8:512:bfly"]
    labels = set()
    for name in names:
        label, fn = tool.variant(name)
        labels.add(label)
        out = fn(C, ds[0])
        if name.startswith("shipped"):
            out = SK.pack_maps(*out)
        twice = name in ("shipped2", "2nat") or name.startswith("2nat:")
        ref = SK.wta_packed_plain(C, ds * 2, tool.UNIQUENESS, tool.MIN_DISP) if twice else want
        assert torch.equal(out, ref), name
    assert len(labels) == len(names)
    for bad in ("foo", "8:128", "8:128:tree", "nat:8"):
        with pytest.raises(ValueError):
            tool.variant(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["16", "nat"]) == 2
    assert "CUDA" in capsys.readouterr().err
