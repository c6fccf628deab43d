"""A backlog of JPEG pairs (the mix's files) drawn, cycled, through the
program's ``PrefetchLoader`` (``batch_size``, ``prefetch``, ``threads``,
``decoder``): each batch's dense step and clouds are queued, then the batch
before is waited for, as ``stream_reconstruct`` does, so a batch's clouds
are copied while the next batch computes."""

from __future__ import annotations

import time

import numpy as np

from benchmark import traffic
from stereo_reconstruction_cv_tpu_torch import native
from stereo_reconstruction_cv_tpu_torch.parallel.prefetch import PrefetchLoader

# Pairs a second that a backlog is sized for: several times what the card
# reaches at 720p, so the window closes before the backlog runs out.
RATE_CAP = 1000.0


def loader_args(run: traffic.Run) -> dict:
    mix = run.mix
    return dict(batch_size=mix["batch_size"], prefetch=mix["prefetch"],
                num_threads=mix["threads"], gray=True, decoder=mix["decoder"],
                device=run.device)


def prepare(run: traffic.Run) -> None:
    """Build the decoder on this thread (the loader's threads would race to
    build it in a checkout's first run), then pass every file once through
    the loader and the chain."""
    native.load_image(run.files[0][0], True, run.mix["decoder"])
    b = run.mix["batch_size"]
    with PrefetchLoader(run.files, **loader_args(run)) as loader:
        for i, (lefts, rights) in enumerate(loader):
            index = list(range(i * b, i * b + lefts.shape[0]))
            for event, _ in traffic.run_pairs(run.chain, run.span, lefts, rights, index):
                traffic.wait(event)


def window(run: traffic.Run, seconds: float) -> traffic.Window:
    b = run.mix["batch_size"]
    files = run.files
    count = int(np.ceil(seconds * RATE_CAP / b)) * b
    items = [files[i % len(files)] for i in range(count)]
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
                index = [(issued + j) % len(files) for j in range(lefts.shape[0])]
                issued += lefts.shape[0]
                batch = traffic.run_pairs(run.chain, span, lefts, rights, index)
                with span("wait"):
                    finish(pending)
                pending = batch
            with span("wait"):
                finish(pending)
        decoded, copies = loader.images_decoded, loader.h2d_copies
    completed = sum(t <= t_end for t in done)
    counts_ok = decoded >= 2 * issued and (run.device.type != "cuda" or copies >= issued // b)
    return traffic.Window(seconds=t_end - t_start, issued=issued, completed=completed,
                          finished=len(done), latencies_s=None, loader_wait_s=waited,
                          counts_ok=counts_ok)
