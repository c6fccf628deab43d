"""A backlog of JPEG pairs (the mix's files) drawn, cycled, through the
program's ``PrefetchLoader`` onto the chain's device mesh (``batch_size``,
``prefetch``, ``threads``, ``decoder``, ``sharding=batch_row_sharding``):
each batch's sharded dense step and its clouds are queued, then the batch
before is waited for, as ``stream_reconstruct(mesh=)`` does."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import traffic
from stereo_reconstruction_cv_tpu_torch import native
from stereo_reconstruction_cv_tpu_torch.parallel.mesh import batch_row_sharding
from stereo_reconstruction_cv_tpu_torch.parallel.prefetch import PrefetchLoader

# Pairs a second that a backlog is sized for: several times what four cards
# reach at 4K, so the window closes before the backlog runs out.
RATE_CAP = 1000.0


def loader_args(run: traffic.Run) -> dict:
    mix = run.mix
    return dict(batch_size=mix["batch_size"], prefetch=mix["prefetch"],
                num_threads=mix["threads"], gray=True, decoder=mix["decoder"],
                sharding=batch_row_sharding(run.chain.mesh))


def cycled(files: list, count: int) -> list:
    return [files[i % len(files)] for i in range(count)]


def frame(x, i: int, device) -> torch.Tensor:
    """Pair i's whole frame of a Sharded batch, on `device`."""
    b = x.blocks[0][0].shape[0]
    return torch.cat([blk[i % b].to(device) for blk in x.blocks[i // b]])


def run_batch(run: traffic.Run, lefts, rights, index: list) -> list:
    """Queue one Sharded batch's dense step and each pair's cloud ->
    [(event, make-record)] per pair."""
    chain, span = run.chain, run.span
    with span("step"):
        disp, pts, valid = chain.dense(lefts, rights)
    out = []
    for i in range(len(disp)):
        with span("cloud"):
            host_pts, host_n, event = chain.cloud(disp[i], pts[i], valid[i])

        def make(i=i, host_pts=host_pts, host_n=host_n):
            dev = disp[i].device
            return traffic.Pair(index[i], (frame(lefts, i, dev), frame(rights, i, dev)), disp[i],
                                valid[i], host_pts, host_n)
        out.append((event, make))
    return out


def prepare(run: traffic.Run) -> None:
    """Build the decoder on this thread (the loader's threads would race to
    build it in a checkout's first run), then pass every file once, in
    whole batches, through the loader and the chain."""
    native.load_image(run.files[0][0], True, run.mix["decoder"])
    b = run.mix["batch_size"]
    items = cycled(run.files, -(-len(run.files) // b) * b)
    with PrefetchLoader(items, **loader_args(run)) as loader:
        for i, (lefts, rights) in enumerate(loader):
            index = [(i * b + j) % len(run.files) for j in range(b)]
            for event, _ in run_batch(run, lefts, rights, index):
                traffic.wait(event)


def window(run: traffic.Run, seconds: float) -> traffic.Window:
    b = run.mix["batch_size"]
    files = run.files
    items = cycled(files, int(np.ceil(seconds * RATE_CAP / b)) * b)
    done, waited, pending, issued = [], 0.0, [], 0
    span = run.span

    def finish(batch):
        for event, _ in batch:
            traffic.wait(event)
            done.append(time.perf_counter())
        if batch:
            run.sampler.offer([make for _, make in batch])

    with PrefetchLoader(items, **loader_args(run)) as loader:
        it = iter(loader)
        traffic.sync(run.device)
        with span("window"):
            t_start = time.perf_counter()
            t_end = t_start + seconds
            while time.perf_counter() < t_end:
                t0 = time.perf_counter()
                with span("loader_wait"):
                    got = next(it, None)
                waited += time.perf_counter() - t0
                if got is None:  # the backlog ran out: the window ends here
                    t_end = time.perf_counter()
                    break
                lefts, rights = got
                index = [(issued + j) % len(files) for j in range(b)]
                issued += b
                batch = run_batch(run, lefts, rights, index)
                with span("wait"):
                    finish(pending)
                pending = batch
            with span("wait"):
                finish(pending)
        decoded, copies = loader.images_decoded, loader.h2d_copies
    completed = sum(t <= t_end for t in done)
    counts_ok = decoded >= 2 * issued and (run.device.type != "cuda" or copies >= 2 * issued)
    return traffic.Window(seconds=t_end - t_start, issued=issued, completed=completed,
                          finished=len(done), latencies_s=None, loader_wait_s=waited,
                          counts_ok=counts_ok)
