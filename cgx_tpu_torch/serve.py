"""Long-lived serving mode: build or load the corpus index once, then answer
query batches until EOF (copy of ``cgx_tpu/serve.py``).

The reference's closest analog is its persisted ``sa_precomp.txt`` reuse
(SuffixArray.c:208-230), which still relaunched the whole binary, and paid
the whole device-side setup, once per query batch.  Here the process keeps
the device-resident index, the loaded kernel libraries and the engine
context across requests, so a request pays only its own query work.  Each
request runs the one-shot path's stages (``pipeline._front_stages`` and
``_back_stages``) on that context, so it launches the one-shot path's
kernels.

Protocol (stdin, one request per line):

    <query_file> <dest_dir>

writes ``dest_dir/grammar.<i>.{s,n}`` per query (the same bytes as a
one-shot ``cgx_tpu_torch.cli`` run over the same corpus and queries) and
answers on stdout:

    ok <n_queries> <n_grammar_lines> <seconds>

or ``err <what>`` for a bad request line or a batch that failed; serving
goes on.  The first line is ``ready <seconds>``, after the index and the
prewarm batch (``warn ...`` before it when the prewarm failed).

Usage:
    python -m cgx_tpu_torch.serve <source_corpus> <target_corpus> \
        <alignment_file> <lex_file> [--index-dir DIR] [--sa-shards N] \
        [--no-sample] [--device cuda|cpu] [--prewarm QRYFILE|auto] \
        [--no-prewarm] [--prewarm-queries N]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from cgx_tpu_torch.cli import _shards_arg
from cgx_tpu_torch.config import DEFAULT_CONFIG


def serve_loop(reffile, tarfile, alignfile, lexfile, cfg=DEFAULT_CONFIG,
               index_dir=None, sa_shards: int = 0, inp=None, out=None,
               prewarm="auto", prewarm_queries: int = 16,
               device="cuda") -> int:
    """Run the serve protocol over ``inp``/``out`` streams (stdin/stdout by
    default) with the index on ``device`` ("cuda" raises when no card is
    present; "cpu" runs the kernels' plain versions).  Returns the number of
    requests served.

    ``prewarm`` names a query file run through the full path (output
    discarded) before ``ready`` is printed, so the first real request does
    not pay the first use of each kernel library (its build, or its load
    when built) and of the device.  The default ``"auto"`` takes
    ``prewarm_queries`` of the corpus's own sentences (always in the
    vocabulary).  ``None`` disables prewarming."""
    import torch
    from cgx_tpu_torch import pipeline as tpl
    from cgx_tpu_torch.grammar import writer as gw
    from cgx_tpu_torch.preproc import corpus as cp
    from cgx_tpu_torch.utils.timing import PhaseTimer

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")
    inp = sys.stdin if inp is None else inp
    out = sys.stdout if out is None else out

    with open(reffile, encoding="utf-8") as fh:
        f_text = fh.read()
    with open(tarfile, encoding="utf-8") as fh:
        e_text = fh.read()
    t0 = time.perf_counter()
    art, index, t = tpl.build_artifact(
        f_text, e_text, cp.read_lines(alignfile), cp.read_tokens(lexfile),
        cfg, device=device, sa_shards=sa_shards, index_dir=index_dir)
    ctx = tpl._make_context(art, index, t, cfg, sa_shards)

    def run(queries):
        bt = PhaseTimer(device)
        front = tpl._front_stages(ctx, queries, cfg, bt)
        return tpl._back_stages(ctx, queries, front, cfg, bt)

    if prewarm is not None:
        # a bad prewarm file must not kill the server before 'ready':
        # orchestrators block on that line, and per-request errors are
        # reported inline, so a prewarm failure is reported the same way
        try:
            if prewarm == "auto":
                sents = [ln for ln in f_text.split("\n") if ln.strip()]
                reps = -(-max(prewarm_queries, 1) // max(len(sents), 1))
                q_lines = (sents * reps)[:prewarm_queries]
            else:
                q_lines = cp.read_lines(prewarm)
            run(cp.load_queries(q_lines, art.source.vocab))
        except Exception as exc:
            print(f"warn prewarm failed {type(exc).__name__}: {exc}",
                  file=out, flush=True)
    print(f"ready {time.perf_counter() - t0:.3f}", file=out, flush=True)

    served = 0
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            qryfile, dest = line.split()
        except ValueError:
            print(f"err bad request line: {line!r}", file=out, flush=True)
            continue
        t1 = time.perf_counter()
        try:
            queries = cp.load_queries(cp.read_lines(qryfile),
                                      art.source.vocab)
            lines, counters = run(queries)
            gw.write_grammars(dest, queries.qryscount, cfg.is_sample, lines)
        except Exception as exc:   # keep serving after a bad batch
            print(f"err {type(exc).__name__}: {exc}", file=out, flush=True)
            continue
        print(f"ok {queries.qryscount} {counters['total_lines']} "
              f"{time.perf_counter() - t1:.3f}", file=out, flush=True)
        served += 1
    return served


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cgx_tpu_torch.serve", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("reffile")
    p.add_argument("reftargetfile")
    p.add_argument("alignfile")
    p.add_argument("lexfile")
    p.add_argument("--index-dir", default=None,
                   help="persisted corpus-index dir (built on first use)")
    p.add_argument("--sa-shards", type=_shards_arg, default=0, metavar="N",
                   help="sharded-index mode: N shards, all on --device")
    p.add_argument("--no-sample", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the index and the kernels (default cuda)")
    p.add_argument("--prewarm", default="auto", metavar="QRYFILE",
                   help="run this query batch (output discarded) before "
                        "printing ready, so the first request does not pay "
                        "the first use of the kernel libraries and the "
                        "device (default: a batch of the corpus's own "
                        "sentences)")
    p.add_argument("--no-prewarm", action="store_true",
                   help="disable the default prewarm batch")
    p.add_argument("--prewarm-queries", type=int, default=16, metavar="N",
                   help="auto-prewarm batch size")
    args = p.parse_args(argv)
    cfg = dataclasses.replace(DEFAULT_CONFIG, is_sample=not args.no_sample)
    serve_loop(args.reffile, args.reftargetfile, args.alignfile, args.lexfile,
               cfg, index_dir=args.index_dir, sa_shards=args.sa_shards,
               prewarm=None if args.no_prewarm else args.prewarm,
               prewarm_queries=args.prewarm_queries, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
