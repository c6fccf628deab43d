"""Port vs JAX reference: the 16-bit op-chain probe.

The plain ``op_chain_plain`` (CPU tensors) against ``tools/micro_i16.py``'s
``_chain_kernel``, launched with ``pl.pallas_call`` exactly as its ``run``
builds it and run under ``pltpu.force_tpu_interpret_mode()``, for all nine
dtype x ops cases, bit for bit. REPS is cut to a few steps and the shape to
512 x 128 so that it stays quick; the roll chains pin the direction of
``pltpu.roll`` (out[i] = x[i - 1]) against ``torch.roll``. The same holds at
the wrap edge (``micro_i16.edge_values``: integer adds that wrap, float adds
that round) in all eight op sets, so the kernel's wrap semantics, held to
the plain version on the card, are the reference's.
"""

import functools
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stereo_reconstruction_cv_tpu_torch import _build
from stereo_reconstruction_cv_tpu_torch.ops.cuda import op_chain as OC

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE_SETTINGS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
H, W, REPS = 512, 128, 6
CASES = ([(dt, ("add", "min")) for dt in ("float32", "int32", "int16", "uint16", "bfloat16")]
         + [(dt, ("roll", "add", "min")) for dt in ("float32", "int32", "int16", "uint16")])
ALL_OPS = [(), ("roll",), ("add",), ("roll", "add"), ("min",), ("roll", "min"), ("add", "min"),
           ("roll", "add", "min")]


@pytest.fixture(scope="module")
def micro_i16():
    """tools/micro_i16.py imported by path; the compilation-cache options and
    sys.path it sets at import are put back."""
    saved = {k: getattr(jax.config, k) for k in CACHE_SETTINGS}
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("_reference_micro_i16",
                                                  ROOT / "tools" / "micro_i16.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


def _reference(micro_i16, x, ops):
    """micro_i16.run's pallas_call, in interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        fn = pl.pallas_call(
            functools.partial(micro_i16._chain_kernel, ops=ops),
            grid=(H // 256,),
            in_specs=[pl.BlockSpec((256, W), lambda i: (i, 0), memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((256, W), lambda i: (i, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((H, W), x.dtype),
        )
        return fn(x)


def _plain(xn, dtype, ops):
    """op_chain_plain on a numpy array (float32 for bfloat16) -> numpy."""
    got = OC.op_chain_plain(torch.from_numpy(np.ascontiguousarray(xn)).to(getattr(torch, dtype)),
                            ops, reps=REPS)
    assert got.dtype == getattr(torch, dtype)
    return got.float().numpy() if dtype == "bfloat16" else got.numpy()


@pytest.mark.parametrize("dtype,ops", CASES, ids=[f"{d}-{'+'.join(o)}" for d, o in CASES])
def test_chain_matches_reference(micro_i16, monkeypatch, dtype, ops):
    monkeypatch.setattr(micro_i16, "REPS", REPS)
    x = jnp.asarray(np.random.default_rng(0).integers(1, 1000, (H, W)), getattr(jnp, dtype))
    as_np = jnp.float32 if dtype == "bfloat16" else x.dtype
    ref = np.asarray(_reference(micro_i16, x, ops).astype(as_np))
    xn = np.array(x.astype(as_np))
    got = _plain(xn, dtype, ops)
    np.testing.assert_array_equal(got, ref)
    if "roll" in ops:  # the chain moved values, and a roll the other way would not match
        assert not np.array_equal(got, xn)
        assert not np.array_equal(_plain(xn[:, ::-1], dtype, ops)[:, ::-1], ref)
    else:  # min(x, x + 1) is the identity
        np.testing.assert_array_equal(got, xn)


@pytest.mark.parametrize("ops", ALL_OPS, ids=["+".join(o) or "none" for o in ALL_OPS])
@pytest.mark.parametrize("dtype", ["float32", "int32", "int16", "uint16", "bfloat16"])
def test_chain_matches_reference_at_the_wrap_edge(micro_i16, monkeypatch, dtype, ops):
    from stereo_reconstruction_cv_tpu_torch.tools import micro_i16 as tool

    monkeypatch.setattr(micro_i16, "REPS", REPS)
    x = jnp.asarray(tool.edge_values(getattr(torch, dtype), H, W), getattr(jnp, dtype))
    as_np = jnp.float32 if dtype == "bfloat16" else x.dtype
    ref = np.asarray(_reference(micro_i16, x, ops).astype(as_np))
    xn = np.array(x.astype(as_np))
    got = _plain(xn, dtype, ops)
    np.testing.assert_array_equal(got, ref)
    if "add" in ops and dtype in ("int16", "int32"):  # some adds wrapped
        assert (got < 0).any() and not (xn < 0).any()
    if "add" in ops and dtype == "uint16":
        assert (got < 8).sum() > (xn < 8).sum()


def test_wrapper_runs_the_full_chain_and_checks_arguments():
    x = torch.from_numpy(np.random.default_rng(1).integers(1, 1000, (3, 64))).to(torch.int16)
    before = dict(OC.launches)
    ops = ("roll", "add", "min")
    assert torch.equal(OC.op_chain(x, ops), OC.op_chain_plain(x, ops, reps=OC.REPS))
    assert OC.launches == before
    with pytest.raises(ValueError, match="unknown ops"):
        OC.op_chain(x, ("roll", "mul"))
    with pytest.raises(ValueError, match="dtype"):
        OC.op_chain(x.double(), ops)
    with pytest.raises(ValueError, match="W in"):
        OC.op_chain(x[:, :48], ops)


def test_tool_cases_and_refusal_without_a_card(monkeypatch, capsys):
    """The port's micro_i16 runs the reference's nine cases on its input;
    without a CUDA device main() exits 2."""
    from stereo_reconstruction_cv_tpu_torch.tools import micro_i16 as tool

    assert [(str(d).split(".")[-1], o) for d, o in tool.CASES] == CASES
    x = tool.make_input(torch.int16, 4, 32)
    np.testing.assert_array_equal(x.numpy(), np.random.default_rng(0).integers(1, 1000, (4, 32)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main() == 2
    assert "CUDA" in capsys.readouterr().err


@pytest.mark.parametrize("capturing,added", [(False, 1), (True, 0)])
def test_launch_count_skips_calls_captured_into_a_graph(monkeypatch, capturing, added):
    """A wrapper counts a launch, but not a call recorded into a CUDA graph
    (the graph's replays launch the kernel; utils/timing.graph_ms counts them)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    counts = {"op_chain": 3}
    _build.count(counts, "op_chain")
    assert counts == {"op_chain": 3 + added}

