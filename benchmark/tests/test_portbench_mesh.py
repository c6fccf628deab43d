"""The four-card cell on the CPU at a tiny size, as the harness's tests run the
one-card cells: ``correct`` true on a sound run, false under the control and
when one shard's halo rows are left out, and a tiny run on four cards."""

import pytest
import torch

from benchmark import control, harness

CPU = torch.device("cpu")
MESH = "logitech4k_sgbm256_mesh2x2.backlog_mesh4"


def run_tiny(tiny, chain_cls=None, seed=2**31 + 12345, **mix):
    return harness.run_cell(MESH, seed, 0.4, False, CPU, 0.0, chain_cls=chain_cls,
                            overrides=tiny(MESH.split(".")[0], decoder="libjpeg", **mix))


def test_sound_run_is_correct(tiny):
    r = run_tiny(tiny)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert {"pairs_per_s", "setup_s"} <= set(r["metrics"])


def test_control_is_not_correct(tiny):
    for seed in (1, 2, 3):
        numbers, limits = control.control_numbers(
            MESH, seed, CPU, overrides=tiny(MESH.split(".")[0], decoder="libjpeg"))
        assert any(v > limits[k] for k, v in numbers.items()), numbers


class _NoTopHalo(harness.piece("chains", "sgbm_mesh").Chain):
    """The port's mesh chain with one fault planted underneath: the second row
    shard of every frame runs without the halo rows it takes from the shard
    above."""

    def dense(self, lefts, rights):
        from stereo_reconstruction_cv_tpu_torch.parallel import sgm_sharded as SS

        extend = SS._extend

        def no_top_halo(blocks, n):
            ext, tops = extend(blocks, n)
            ext[1], tops[1] = ext[1][tops[1]:], 0
            return ext, tops
        SS._extend = no_top_halo
        try:
            return super().dense(lefts, rights)
        finally:
            SS._extend = extend


def test_missing_halo_is_not_correct(tiny):
    """On three seeds, with 3 distinct pairs so no two consecutive batches
    are alike."""
    for seed in (2**31 + 12345, 7, 4_000_000_001):
        r = run_tiny(tiny, chain_cls=_NoTopHalo, pairs=3, seed=seed)
        assert not r["correct"], (seed, r["checks"])


@pytest.mark.gpu
def test_tiny_run_on_four_cards(tiny):
    chips = harness.load_cell(MESH)[0]["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{MESH} needs {chips} CUDA devices")
    card = torch.device("cuda", torch.cuda.current_device())
    r = harness.run_cell(MESH, 5, 0.5, True, card, 0.0,
                         overrides=tiny(MESH.split(".")[0], decoder="nvjpeg"))
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0 and 0 < r["metrics"]["sgbm_roofline"]["value"] < 100
