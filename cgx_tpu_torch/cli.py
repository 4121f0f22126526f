"""CLI with the same contract as the reference binary (Main.c:29-62) and as the
JAX package's CLI (``cgx_tpu/cli.py``):

    python -m cgx_tpu_torch.cli [-l minmatchlen] [-t fingerlen] [-s timefile] \
        [--no-sample] [--device cuda|cpu] [--sa-shards N] \
        [--engine tpu|oracle] [--index-dir DIR [--build-index-only]] \
        [--query-batches B] [--profile DIR] \
        <source_corpus> <query_file> <target_corpus> <alignment_file> \
        <lex_file> <out_dir>

Writes one grammar file per query sentence: ``out_dir/grammar.<i>.{s,n}``
(PrintResults.c:437-441).  The grammars hold every rule family (ab, Xab,
abX, XabX, aXb, XaXb, aXbX and aXbXc), each line as the JAX package writes
it.
``--device cuda`` (the default) runs the hand-written kernels and fails when
no CUDA device is present; ``--device cpu`` runs their plain PyTorch versions.
``--sa-shards N`` (N > 0) runs the sharded index of N shards, all on that
device; the grammars are the same.  ``--engine oracle`` runs the sequential
numpy oracle (``cgx_tpu_torch.oracle``) on the host whatever ``--device``
says; ``--engine tpu`` (the default, the JAX CLI's name) runs the port's
pipeline on ``--device``.  ``--profile DIR`` writes a ``torch.profiler``
trace of the run (CPU activity, and CUDA activity on the card) to
``DIR/trace.json``.
"""

from __future__ import annotations

import argparse
import contextlib
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
    p.add_argument("--engine", choices=["tpu", "oracle"], default="tpu",
                   help="tpu: the port's pipeline on --device (the JAX "
                        "CLI's name for it); oracle: the sequential numpy "
                        "reference on the host")
    p.add_argument("--index-dir", default=None,
                   help="persisted corpus-index dir (built on first use)")
    p.add_argument("--build-index-only", action="store_true",
                   help="build + persist the corpus index (requires "
                        "--index-dir) and exit without running queries; the "
                        "query-file argument is ignored")
    p.add_argument("--query-batches", type=int, default=0, metavar="B",
                   help="pipeline overlap: split queries into B batches and "
                        "run batch i's host scoring on a worker thread "
                        "while batch i+1's device stages run")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the run to "
                        "DIR/trace.json")
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
    checked = ("reffile", "reftargetfile", "alignfile", "lexfile") \
        if args.build_index_only else \
        ("reffile", "qryfile", "reftargetfile", "alignfile", "lexfile")
    for name in checked:
        path = getattr(args, name)
        if not os.path.exists(path):
            print(f'Can not open {name} "{path}"', file=sys.stderr)
            return 1
    if args.build_index_only and not args.index_dir:
        print("--build-index-only requires --index-dir", file=sys.stderr)
        return 1
    import torch
    oracle = args.engine == "oracle" and not args.build_index_only
    if (not oracle and args.device == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, minmatchlen=args.minmatchlen, fingerlen=args.fingerlen,
        is_sample=not args.no_sample)
    t0 = time.perf_counter()
    with (_profiler(args.profile, args.device, oracle) if args.profile
          else contextlib.nullcontext()) as trace:
        res = _run(args, cfg, oracle)
        wall = time.perf_counter() - t0      # the trace's export excluded
    if trace:
        print(f"profile: {trace}", file=sys.stderr)
    print(f"total: {wall:.3f}s", file=sys.stderr)
    if args.timefile:
        # recordTime analog (Start.cu:392-469): one appended line per run
        with open(args.timefile, "a", encoding="utf-8") as fh:
            if res is not None:
                fh.write(f"wall: {wall:.6f}s , {res.timing.report()}\n")
            else:
                fh.write(f"wall: {wall:.6f}s\n")
    return 0


def _run(args, cfg, oracle: bool):
    """The run the arguments ask for -> its PipelineResult, or None where
    there is none (build-only, oracle)."""
    if args.build_index_only:
        from cgx_tpu_torch.pipeline import build_artifact
        from cgx_tpu_torch.preproc import corpus as cp
        with open(args.reffile, encoding="utf-8") as fh:
            f_text = fh.read()
        with open(args.reftargetfile, encoding="utf-8") as fh:
            e_text = fh.read()
        _, _, t = build_artifact(
            f_text, e_text, cp.read_lines(args.alignfile),
            cp.read_tokens(args.lexfile), cfg, device=args.device,
            sa_shards=args.sa_shards, index_dir=args.index_dir)
        print(f"index built at {args.index_dir}: {t.report()}",
              file=sys.stderr)
        return None
    if oracle:
        from cgx_tpu_torch.oracle.pipeline import run_oracle_files
        run_oracle_files(args.reffile, args.qryfile, args.reftargetfile,
                         args.alignfile, args.lexfile, args.dest_dir, cfg)
        return None
    from cgx_tpu_torch.pipeline import run_pipeline_files
    return run_pipeline_files(args.reffile, args.qryfile, args.reftargetfile,
                              args.alignfile, args.lexfile, args.dest_dir, cfg,
                              device=args.device, sa_shards=args.sa_shards,
                              index_dir=args.index_dir,
                              query_batches=args.query_batches)


@contextlib.contextmanager
def _profiler(out_dir: str, device: str, host_only: bool):
    """A ``torch.profiler`` trace of the block (the JAX CLI's
    ``jax.profiler`` trace): CPU activity, and CUDA activity when the run
    uses the card; written as a Chrome trace to ``out_dir/trace.json``,
    whose path the context yields."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device == "cuda" and not host_only:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


if __name__ == "__main__":
    sys.exit(main())
