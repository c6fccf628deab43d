"""The one traffic generator: it reads a mix's parameters, makes its pairs
from the seed and hands them to the mix's loop.

A mix (``mixes/<name>.json``) says how pairs reach the system:

- ``pairs``: distinct pairs a run renders from its seed and cycles through;
- ``rig``: "raw" (the frames come from the raw rig, so the chain rectifies
  them on the card) or "rectified" (a recorded rectified video: nothing to
  rectify);
- ``jpeg_quality`` (optional): the pairs are stored at set-up as JPEG files
  of this quality, which the loop draws from disk;
- ``loop``: the name of the loop that drives the chain, ``loops/<loop>.py``,
  with the rest of the mix's keys as its parameters.

A loop is a module with two functions of a ``Run``: ``prepare(run)``, which
warms every shape the window uses along the window's own path (set-up), and
``window(run, seconds)``, which drives the chain for `seconds` and returns a
``Window``. It offers each batch it finishes to ``run.sampler``. A later mix
with a loop of its own adds a loop file; one with an existing loop is data
alone.

Every seed renders the same scene geometry with other textures, so every
seed gives the same sizes and the same work.
"""

from __future__ import annotations

import concurrent.futures
import os
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import scene


@dataclass
class Pair:
    """The window's record of one pair, kept only for the sampled ones."""
    index: int                 # which distinct pair
    frames: tuple              # the frames the dense step took (rectified or decoded)
    disp: torch.Tensor
    valid: torch.Tensor
    host_pts: torch.Tensor
    host_n: torch.Tensor


@dataclass
class Window:
    seconds: float             # the window's length on the host clock
    issued: int                # pairs handed to the chain inside the window
    completed: int             # pairs whose cloud reached the host inside it
    finished: int              # pairs whose cloud reached the host at all
    latencies_s: list | None   # per issued pair, where the loop hands pairs over one by one
    loader_wait_s: float | None
    counts_ok: bool            # the loop's own counters cover every pair it counts


class Sampler:
    """A uniform sample of k of the window's batches, drawn from the seed
    (reservoir sampling over the batches in the order they finish). Every
    pair of a kept batch is checked, so each position in a batch is."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng((seed + 0x5EED) % (1 << 64))
        self.batches: list = []
        self.seen = 0

    def offer(self, makes):
        """`makes`: one callable a pair of the batch that builds its record;
        called only if the batch is kept."""
        if len(self.batches) < self.k:
            self.batches.append([m() for m in makes])
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.batches[j] = [m() for m in makes]
        self.seen += 1

    @property
    def kept(self) -> list:
        return [p for batch in self.batches for p in batch]


@dataclass
class Run:
    """What a loop drives: the chain, the cell's parameters and its pairs."""
    chain: object              # the program's chain (chains/<chain>.py's Chain)
    span: object               # trace.Spans
    config: dict
    mix: dict
    pairs: list                # [(left, right)] uint8 host arrays of the distinct pairs
    files: list | None         # [(left, right)] paths of each pair's files, or None
    device: torch.device
    sampler: Sampler | None = None  # set once set-up is done


def rectifies(mix: dict) -> bool:
    """Whether the chain rectifies the frames: those of the raw rig."""
    return mix["rig"] == "raw"


def render(config: dict, mix: dict, seed: int, device) -> tuple:
    """(the mix's rig (K, R, T), [(left, right) uint8 host arrays] of its
    distinct pairs), rendered on `device` from `seed`."""
    K, R, T = scene.rig(config, mix["rig"])
    H, W = config["height"], config["width"]
    pairs = []
    for s in scene.texture_seeds(seed, mix["pairs"]):
        left, right = scene.render_pair(K, R, T, H, W, s, device)
        pairs.append((left.cpu().numpy(), right.cpu().numpy()))
    return (K, R, T), pairs


def write_files(pairs, mix: dict, folder: str, threads: int = 4) -> list | None:
    """Each pair as two grayscale JPEGs of the mix's ``jpeg_quality`` under
    `folder` -> [(left, right) paths]; None for a mix without files."""
    if "jpeg_quality" not in mix:
        return None
    from PIL import Image

    def save(job):
        img, path = job
        Image.fromarray(img).save(path, quality=mix["jpeg_quality"])

    jobs, rows = [], []
    for i, pair in enumerate(pairs):
        row = tuple(os.path.join(folder, f"pair{i}_{side}.jpg") for side in "lr")
        jobs += list(zip(pair, row))
        rows.append(row)
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        list(pool.map(save, jobs))
    return rows


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wait(event):
    if event is not None:
        event.synchronize()


def run_pairs(chain, span, frames_l, frames_r, index):
    """Rectify (when the chain does), run the dense step on the batch and
    queue each pair's cloud: -> [(event, make-record)] per pair."""
    with span("rectify"):
        rect = [chain.rectify(l, r) for l, r in zip(frames_l, frames_r)]
    lefts = torch.stack([l for l, _ in rect]) if chain.maps is not None else frames_l
    rights = torch.stack([r for _, r in rect]) if chain.maps is not None else frames_r
    with span("step"):
        disp, pts, valid = chain.dense(lefts, rights)
    out = []
    for i in range(disp.shape[0]):
        with span("cloud"):
            host_pts, host_n, event = chain.cloud(disp[i], pts[i], valid[i])

        def make(i=i, host_pts=host_pts, host_n=host_n):
            return Pair(index[i], rect[i], disp[i], valid[i], host_pts, host_n)
        out.append((event, make))
    return out


def warm_host_pairs(run: Run) -> None:
    """One pass over every distinct pair, one at a time from host memory:
    every shape a loop of single host pairs uses, and the allocators."""
    for k, (left, right) in enumerate(run.pairs):
        lt, rt = (torch.from_numpy(f).to(run.device) for f in (left, right))
        for event, _ in run_pairs(run.chain, run.span, [lt], [rt], [k]):
            wait(event)
