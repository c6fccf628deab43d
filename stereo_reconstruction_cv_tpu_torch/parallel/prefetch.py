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

With ``sharding=`` (``parallel.mesh.batch_row_sharding`` or
``batch_sharding``), each batch is placed on a device mesh instead: every
grid cell's slice of a frame (its pairs, its rows) is copied from the pinned
batch to its device on that device's side stream, one copy per frame slice,
and the batch comes out as one ``Sharded`` per column; the consumer's stream
on each device waits on that device's event.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Iterator, List, Sequence, Tuple

import torch

from stereo_reconstruction_cv_tpu_torch import native
from stereo_reconstruction_cv_tpu_torch.errors import DataError
from stereo_reconstruction_cv_tpu_torch.parallel.mesh import Sharded, Sharding, block_ranges
from stereo_reconstruction_cv_tpu_torch.utils.profiling import span


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
    else one per column; with `sharding`, one per frame slice). With
    `sharding` (a mesh.Sharding over 'data', or 'data' and 'space') each
    column comes as a Sharded tensor on the mesh and `device` is not used.
    Close it (or use it in a with block) to stop its threads."""

    def __init__(
        self,
        items: Sequence[Tuple[str, ...]],
        batch_size: int = 1,
        prefetch: int = 2,
        gray: bool = True,
        num_threads: int = 4,
        decoder: str = "libjpeg",
        device="cuda",
        sharding: Sharding | None = None,
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
        self.sharding = sharding
        self._stream = None
        self._streams = {}  # with a sharding: a side stream per CUDA device of the mesh
        if sharding is not None:
            if sharding.spec not in (("data",), ("data", "space")):
                raise ValueError(f"sharding spec {sharding.spec}: ('data',) or ('data', 'space')")
            for row in sharding.mesh.devices:
                for d in row:
                    if d.type == "cuda" and d not in self._streams:
                        self._streams[d] = torch.cuda.Stream(d)
        elif self.device.type == "cuda":
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
        pin = self._stream is not None or bool(self._streams)
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
        """(column tensors on the device, the copy's event or None; with a
        sharding, Sharded columns and an event per CUDA device)."""
        datas = [[_read(row[c]) for row in batch] for c in range(len(batch[0]))]
        bufs, slots, stacked = self._host_buffers(batch, datas)
        futs = [self._decode_pool.submit(self._decode, row[c], datas[c][i], slots[c][i])
                for c in range(len(slots)) for i, row in enumerate(batch)]
        for f in futs:
            f.result()
        if self.sharding is not None:
            return self._place(tuple(bufs[0]) if stacked else tuple(bufs))
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

    def _place(self, cols):
        """Host columns (B, H, ...) -> (Sharded columns, {device: event}):
        each grid cell's frame slices copied on its device's side stream."""
        mesh = self.sharding.mesh
        events, out = {}, []
        for col in cols:
            brs, rrs = block_ranges(col.shape, self.sharding)
            blocks = []
            for (b0, b1), row in zip(brs, mesh.devices):
                blocks.append([])
                for (r0, r1), dev in zip(rrs, row):
                    part = col[b0:b1, r0:r1]
                    if dev.type != "cuda":
                        blocks[-1].append(part.clone())
                        continue
                    with torch.cuda.device(dev), torch.cuda.stream(self._streams[dev]):
                        blk = torch.empty(part.shape, dtype=part.dtype, device=dev)
                        for k in range(part.shape[0]):  # each frame slice is contiguous
                            blk[k].copy_(part[k], non_blocking=True)
                    blocks[-1].append(blk)
                    with self._lock:
                        self.h2d_copies += part.shape[0]
            out.append(Sharded(self.sharding, blocks, col.shape))
        for dev, stream in self._streams.items():
            events[dev] = torch.cuda.Event()
            events[dev].record(stream)
        return tuple(out), events

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
            with span("input.take"):
                future = inflight.pop(i)
                if future.done():
                    cols, event = future.result()
                else:
                    with span("input.stall"):
                        cols, event = future.result()
                if isinstance(event, dict):  # a mesh: each device's event and blocks
                    for dev, ev in event.items():
                        stream = torch.cuda.current_stream(dev)
                        stream.wait_event(ev)
                        for col in cols:
                            for row in col.blocks:
                                for t in row:
                                    if t.device == dev:
                                        t.record_stream(stream)
                elif event is not None:
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
