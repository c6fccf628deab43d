"""Host-side helpers: display (draw) and CUDA-event timing (timing)."""
