"""Host -> device prefetching JPEG loader (after ``stereo_reconstruction_cv_tpu/parallel/prefetch.py``).

Streams stereo pairs (or any rows of JPEG paths) to the device while the
previous batch computes. Each batch is read and decoded on thread pools
through ``native.decode_jpeg`` (the C call releases the GIL, so decodes run
in parallel with each other and with the consumer), straight into one pinned
host tensor per batch; its host -> device copy is issued with
``non_blocking=True`` on the loader's side stream and followed by an event.
When the consumer takes the batch, its current stream waits on that event
and the batch's device memory is marked as used by that stream
(``record_stream``), so it can read neither a frame whose copy is still in
flight nor a buffer the allocator has handed out again. Each batch's pinned
tensor comes from torch's caching host allocator, which reuses it only after
the copy from it has completed, so a frame is never overwritten mid-copy.

The reference's ``sharding=`` (batches placed on a device mesh) belongs to the
multi-device port (ROADMAP A.16) and is not here.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Iterator, List, Sequence, Tuple

import torch

from stereo_reconstruction_cv_tpu_torch import native
from stereo_reconstruction_cv_tpu_torch.errors import DataError


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


class PrefetchLoader:
    """Iterate batches of decoded images with lookahead.

    items: sequence of path tuples, e.g. [(left0, right0), (left1, right1)].
    Yields tuples of stacked uint8 tensors on `device`, one per path column,
    (B, H, W) gray or (B, H, W, 3) RGB; batches come in order, `prefetch`
    of them decoded and copied ahead. `decoder` is one of native.DECODERS.
    images_decoded and h2d_copies count this loader's decodes and
    host -> device copies (one per batch when all its frames share a shape,
    else one per column). Close it (or use it in a with block) to stop its
    threads."""

    def __init__(
        self,
        items: Sequence[Tuple[str, ...]],
        batch_size: int = 1,
        prefetch: int = 2,
        gray: bool = True,
        num_threads: int = 4,
        decoder: str = "libjpeg",
        device="cuda",
    ):
        native.check_decoder(decoder)
        self.items = [tuple(row) for row in items]
        self.batch_size = batch_size
        self.prefetch = max(1, prefetch)
        self.gray = gray
        self.decoder = decoder
        self.device = torch.device(device)
        self.images_decoded = 0
        self.h2d_copies = 0
        self._lock = threading.Lock()
        self._stream = None
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self.device)
        self._decode_pool = concurrent.futures.ThreadPoolExecutor(num_threads)
        self._batch_pool = concurrent.futures.ThreadPoolExecutor(self.prefetch)

    def _batches(self) -> List[List[Tuple[str, ...]]]:
        b = self.batch_size
        return [self.items[i : i + b] for i in range(0, len(self.items), b)]

    def _decode(self, path: str, data: bytes, out) -> None:
        try:
            native.decode_jpeg(data, self.gray, self.decoder, out.numpy())
        except DataError as e:
            raise DataError(f"{path}: {e}") from None
        with self._lock:
            self.images_decoded += 1

    def _host_buffers(self, batch, datas):
        """Pinned (CUDA) or plain host tensors for the batch: one (ncols, B,
        ...) tensor when every frame shares a shape, else one (B, ...) per
        column; each frame's slot; whether the first form was taken."""
        cols = range(len(batch[0]))
        shapes = [[native.jpeg_info(d, self.decoder)[:2] for d in datas[c]] for c in cols]
        pin = self._stream is not None
        extra = () if self.gray else (3,)

        def empty(*shape):
            return torch.empty(shape, dtype=torch.uint8, pin_memory=pin)

        if len({s for col in shapes for s in col}) == 1:
            buf = empty(len(shapes), len(batch), *shapes[0][0], *extra)
            return [buf], [[buf[c, i] for i in range(len(batch))] for c in cols], True
        bufs = []
        for c in cols:
            if len(set(shapes[c])) != 1:
                raise DataError(f"column {c} of the batch {batch} holds frames of sizes {shapes[c]}")
            bufs.append(empty(len(batch), *shapes[c][0], *extra))
        return bufs, [[b[i] for i in range(len(batch))] for b in bufs], False

    def _load_batch(self, batch: List[Tuple[str, ...]]):
        """(column tensors on the device, the copy's event or None)."""
        datas = [[_read(row[c]) for row in batch] for c in range(len(batch[0]))]
        bufs, slots, stacked = self._host_buffers(batch, datas)
        futs = [self._decode_pool.submit(self._decode, row[c], datas[c][i], slots[c][i])
                for c in range(len(slots)) for i, row in enumerate(batch)]
        for f in futs:
            f.result()
        if self._stream is None:
            out = bufs
            event = None
        else:
            with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                out = [torch.empty(b.shape, dtype=b.dtype, device=self.device).copy_(
                    b, non_blocking=True) for b in bufs]
                event = torch.cuda.Event()
                event.record(self._stream)
            with self._lock:
                self.h2d_copies += len(out)
        cols = tuple(out[0]) if stacked else tuple(out)
        return cols, event

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        batches = self._batches()
        inflight = {}

        def submit(i):
            inflight[i] = self._batch_pool.submit(self._load_batch, batches[i])

        for i in range(min(self.prefetch, len(batches))):
            submit(i)
        for i in range(len(batches)):
            nxt = i + self.prefetch
            if nxt < len(batches):
                submit(nxt)
            cols, event = inflight.pop(i).result()
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for t in cols:
                    t.record_stream(stream)
            yield cols

    def __len__(self):
        return (len(self.items) + self.batch_size - 1) // self.batch_size

    def close(self) -> None:
        """Cancel the batches not started and wait for the rest."""
        self._batch_pool.shutdown(wait=True, cancel_futures=True)
        self._decode_pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
