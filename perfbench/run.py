"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell, its configuration, its driver
and its metrics are found by name from ``BENCHMARK.json``.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks`` last: each compared number with its
limit); the same numbers are the last lines of standard error.  Before
them standard error holds what tells a far-off run from its set's others
(``host.py``): the host, set-up's phases, each round's seconds and the
window's host readings.  Without a CUDA card it exits non-zero and prints
no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Build caches at fixed paths inside the checkout; one host thread
    for the numeric libraries, so the run's load is its one process."""
    build = ROOT / "build"
    # the bytecode of every module the run imports, torch's included,
    # compiled on a checkout's first run and read on the later ones: where
    # the environment forbids writing it (PYTHONDONTWRITEBYTECODE) and the
    # library ships none, each run compiles torch's sources anew
    sys.pycache_prefix = str(build / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main() -> int:
    _environment()
    from perfbench import harness

    args = harness.parse_args()
    bench_path = ROOT / "BENCHMARK.json"
    try:
        bench = harness.load_json(bench_path)
        return harness.run(args, T_START, bench)
    except (harness.BenchError, FileNotFoundError, ImportError) as e:
        harness.say(f"{type(e).__name__}: {e}")
        return 2


if __name__ == "__main__":
    sys.exit(main())
