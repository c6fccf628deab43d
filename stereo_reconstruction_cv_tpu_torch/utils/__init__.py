"""Host-side helpers: display (draw), CUDA-event timing (timing), stage metrics
(profiling, capture) and the rendered scenes and boards (synth)."""
