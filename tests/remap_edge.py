"""Source maps on every edge case of the bilinear remap, shared by the CPU
test (tests/test_torch_rectify.py) and the card's (tests/test_torch_gpu.py)."""

import numpy as np


def edge_map(H, W, Ho, Wo, seed):
    """(Ho, Wo, 2) float32 source coordinates on every edge of the remap: off
    the image on all four sides (near, beyond int32, beyond int64), taps
    straddling each border, exact integers, half pixels (rounding ties where
    two taps of odd sum meet) and a tiny negative whose fraction rounds to 1."""
    rng = np.random.default_rng(seed)

    def axis(n):
        special = [-1e30, -3e9, -2.5, -2.0, -1.5, -1.0, -0.5, -1e-7, 0.0, 0.5, 1.0,
                   n - 2, n - 1.5, n - 1, n - 0.5, n - 1e-3, n, n + 0.5, n + 3, 3e9, 1e30]
        return np.concatenate([special, rng.integers(-2, n + 2, 64),
                               rng.integers(-2, n + 2, 64) + 0.5,
                               rng.uniform(-3, n + 3, 64)]).astype(np.float32)

    return np.stack([rng.choice(axis(W), (Ho, Wo)), rng.choice(axis(H), (Ho, Wo))], -1)
