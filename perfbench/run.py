"""Runs one cell of the benchmark once and prints its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration file
(``perfbench/configs/``), its traffic mix (``perfbench/mixes/``) and its
metrics' readers (``perfbench/metrics/``) are found by the names in
``BENCHMARK.json``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last the numbers compared with their
limits); the numbers compared are also the last lines of standard error.
Exits non-zero, with no result, without a CUDA device, without the
program under test, or when a module of JAX or of the JAX package is
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
CACHE = os.path.join(HERE, "cache")
# every build or kernel cache of a run lives inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from perfbench import harness, spec
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"error: the cell needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "cgx_tpu_torch")):
        print("error: the program under test (cgx_tpu_torch) is not in "
              "this checkout", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    run = harness.Run(cell=cell, conf=spec.config(cell["config"]),
                      mix=spec.mix(cell["traffic"]),
                      seed=args.seed % (1 << 64), seconds=args.seconds,
                      trace=bool(args.trace), device="cuda", t0=T0)
    try:
        result, compared = harness.run_cell(run, bench)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    for line in compared:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
