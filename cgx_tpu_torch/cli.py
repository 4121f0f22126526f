"""CLI with the same contract as the reference binary (Main.c:29-62) and as the
JAX package's CLI (``cgx_tpu/cli.py``):

    python -m cgx_tpu_torch.cli [-l minmatchlen] [-t fingerlen] [-s timefile] \
        [--no-sample] [--device cuda|cpu] [--sa-shards N] \
        <source_corpus> <query_file> <target_corpus> <alignment_file> \
        <lex_file> <out_dir>

Writes one grammar file per query sentence: ``out_dir/grammar.<i>.{s,n}``
(PrintResults.c:437-441).  The grammars hold every rule family (ab, Xab,
abX, XabX, aXb, XaXb, aXbX and aXbXc), each line as the JAX package writes
it.
``--device cuda`` (the default) runs the hand-written kernels and fails when
no CUDA device is present; ``--device cpu`` runs their plain PyTorch versions.
``--sa-shards N`` (N > 0) runs the sharded index of N shards, all on that
device; the grammars are the same.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from cgx_tpu_torch.config import DEFAULT_CONFIG


def _shards_arg(v: str) -> int:
    if v == "auto":
        raise argparse.ArgumentTypeError(
            "'auto' sizes the index against the device budget "
            "(utils/budget.py), which is not ported yet (see ROADMAP queue "
            "A); give a shard count")
    try:
        n = int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(f"not a shard count: {v!r}")
    if n < 0:
        raise argparse.ArgumentTypeError(f"shard count {n} < 0")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cgx_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-l", dest="minmatchlen", type=int, default=1)
    p.add_argument("-t", dest="fingerlen", type=int, default=10)
    p.add_argument("-s", dest="timefile", default=None)
    p.add_argument("--no-sample", action="store_true",
                   help="disable occurrence sampling (grammar.<i>.n outputs)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the index and the kernels (default cuda)")
    p.add_argument("--sa-shards", type=_shards_arg, default=0, metavar="N",
                   help="sharded-index mode: split every O(corpus) device "
                        "array into N shards, all on --device (0: the "
                        "replicated index)")
    p.add_argument("reffile")
    p.add_argument("qryfile")
    p.add_argument("reftargetfile")
    p.add_argument("alignfile")
    p.add_argument("lexfile")
    p.add_argument("dest_dir")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (1 <= args.fingerlen <= 10):
        print("finger length must be between 1 and 10", file=sys.stderr)
        return 1
    if args.minmatchlen != 1:
        # In the reference -l only sizes preallocated buffers (ComTypes.h:39-40);
        # it never changes which rules are extracted.
        print(f"warning: -l {args.minmatchlen} accepted for CLI parity but has "
              "no effect on output (buffer-sizing-only flag in the reference)",
              file=sys.stderr)
    for name in ("reffile", "qryfile", "reftargetfile", "alignfile", "lexfile"):
        path = getattr(args, name)
        if not os.path.exists(path):
            print(f'Can not open {name} "{path}"', file=sys.stderr)
            return 1
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, minmatchlen=args.minmatchlen, fingerlen=args.fingerlen,
        is_sample=not args.no_sample)
    t0 = time.perf_counter()
    from cgx_tpu_torch.pipeline import run_pipeline_files
    res = run_pipeline_files(args.reffile, args.qryfile, args.reftargetfile,
                             args.alignfile, args.lexfile, args.dest_dir, cfg,
                             device=args.device, sa_shards=args.sa_shards)
    wall = time.perf_counter() - t0
    print(f"total: {wall:.3f}s", file=sys.stderr)
    if args.timefile:
        # recordTime analog (Start.cu:392-469): one appended line per run
        with open(args.timefile, "a", encoding="utf-8") as fh:
            fh.write(f"wall: {wall:.6f}s , {res.timing.report()}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
