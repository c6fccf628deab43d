"""Shared pieces of the benchmark's CPU tests: the checkout on sys.path, a
tiny size for every configuration, and torch on two threads."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _tiny(config: str, **mix) -> dict:
    """Overrides that shrink a configuration (160 x 48, 16 disparities, the
    paths it states, the batches to check it states) and its mix (2 pairs)
    for a CPU run."""
    with open(ROOT / "benchmark" / "configs" / f"{config}.json") as f:
        sgbm = dict(json.load(f)["sgbm"], num_disparities=16)
    return {"width": 160, "height": 48, "sgbm": sgbm, "pairs": 2, **mix}


@pytest.fixture
def tiny():
    return _tiny


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
