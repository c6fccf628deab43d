"""Streaming: the prefetching JPEG loader and the batched pair -> cloud pipeline."""
