"""Calibration: so far the batched corner refinement that detection uses."""
