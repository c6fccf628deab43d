"""The SGBM layer's work counts for both configurations, checked by hand."""

import json
from pathlib import Path

import pytest

from benchmark import work

ROOT = Path(__file__).resolve().parents[2]

# name: (cells H x (W - D) x D, operations a cell, pixels)
HAND = {
    # 2160 x 3584 x 256; 23 cost + 5 x 8 paths + 6 WTA
    "logitech4k_sgbm256": (1_981_808_640, 69, 8_294_400),
    # 720 x 1152 x 128; 23 cost + 8 x 8 paths + 6 WTA
    "hd720_hh128": (106_168_320, 93, 921_600),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_sgbm_work_by_hand(name):
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        config = json.load(f)
    cells, per_cell, pixels = HAND[name]
    w = work.sgbm_work(config["height"], config["width"], config["sgbm"])
    ops = cells * per_cell + pixels * (20 + 10)  # LR check + speckle a pixel
    assert w["ops"] == ops
    assert w["bytes"] == pixels * 7  # two uint8 frames in, f32 disparity + bool out
    assert w["bound_by"] == "operations"
    assert w["least_s"] == pytest.approx(ops / 67e12, rel=1e-12)


def test_least_times_as_expected():
    """About 2.04 ms a 4K x 256 x 5 frame and 0.148 ms a 720p x 128 x 8 one."""
    k4 = work.sgbm_work(2160, 3840, {"num_disparities": 256, "min_disparity": 0,
                                     "num_directions": 5})
    hd = work.sgbm_work(720, 1280, {"num_disparities": 128, "min_disparity": 0,
                                    "num_directions": 8})
    assert k4["least_s"] == pytest.approx(2.0447e-3, rel=1e-4)
    assert hd["least_s"] == pytest.approx(1.4778e-4, rel=1e-4)
