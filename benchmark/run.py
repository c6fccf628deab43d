"""Run one cell of the port's benchmark on the card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. Sets up the cell named in ``BENCHMARK.json``
(its configuration, its traffic mix), warms every shape it uses, measures
for S seconds, judges the sampled pairs against the plain reference and
prints the numbers compared, each beside its limit, as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last. Exits 2 without printing a
result where no CUDA device (or too few) is present, and 3 where a module of
JAX or of the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_reconstruction_cv_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Kernel and extension caches at fixed paths inside the checkout.
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", torch.cuda.current_device())
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                              T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
