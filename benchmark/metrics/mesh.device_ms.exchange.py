"""Device time per pair of the items launched inside the "exchange" range:
the halo rows that neighbouring row shards copy to each other, and each
shard's extended block (profiler trace, summed over the cards)."""


def read(r):
    if r.trace is None or "exchange" not in r.trace.range_s or not r.window.issued:
        return None
    return 1e3 * r.trace.range_s["exchange"] / r.window.issued
