"""A closed loop, one pair in flight, as a calibrated rig's capture loop
runs it: copy the pair's host frames (pageable, as a camera SDK hands them
over) to the device, run the chain, wait for its cloud on the host; the next
pair is handed over once the last one's cloud is there. No parameters."""

from __future__ import annotations

import time

import torch

from benchmark import traffic


def prepare(run: traffic.Run) -> None:
    traffic.warm_host_pairs(run)


def window(run: traffic.Run, seconds: float) -> traffic.Window:
    host = [tuple(torch.from_numpy(f) for f in p) for p in run.pairs]
    n = len(host)
    lat, done = [], []
    span = run.span
    traffic.sync(run.device)
    with span("window"):
        t_start = time.perf_counter()
        t_end = t_start + seconds
        i = 0
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                break
            k = i % n
            with span("h2d"):
                left = host[k][0].to(run.device)
                right = host[k][1].to(run.device)
            ((event, make),) = traffic.run_pairs(run.chain, span, [left], [right], [k])
            with span("wait"):
                traffic.wait(event)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            done.append(t1)
            run.sampler.offer([make])
            i += 1
    completed = sum(t <= t_end for t in done)
    return traffic.Window(seconds=t_end - t_start, issued=i, completed=completed,
                          finished=len(done), latencies_s=lat, loader_wait_s=None,
                          counts_ok=True)
