"""One run of one cell: set-up, the measured window, the check of what the
window produced against the reference, and the result line.

The entry under test is the program's serve path (``cgx_tpu_torch``):
``pipeline.prepare`` once, then per request ``pipeline.run_queries`` and
``grammar.writer.write_grammars``, as ``serve.serve_loop`` runs them; the
``build`` mix runs ``pipeline.prepare`` without an index directory, back to
back.  The benchmark sees the program only through those calls, the
``PhaseTimer`` it hands to ``prepare`` (``SpanTimer``, which also records
each phase as a profiler range) and ``kernels.build.LAUNCHES``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench import cache, check, spec, trace
from perfbench.gen import corpus as gcorpus
from perfbench.gen import queries as gqueries

# top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "cgx_tpu", "bench", "tools",
             "chip_smoke")
# sentences of the warm-up request of a request mix
WARM_SENTENCES = 4


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def _span(name: str, on: bool):
    """A profiler range ``name`` (``bench:<span>`` or ``phase:<phase>``)
    when ``on``."""
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def span_timer(device, record: bool):
    """A ``PhaseTimer`` of the program that also opens a profiler range
    ``phase:<name>`` around each phase when ``record`` is set."""
    from cgx_tpu_torch.utils.timing import PhaseTimer

    class SpanTimer(PhaseTimer):
        @contextlib.contextmanager
        def phase(self, name, sync=True):
            with _span(f"phase:{name}", record), super().phase(name, sync):
                yield

    return SpanTimer(device)


def launches_total() -> int:
    from cgx_tpu_torch.kernels import build
    return sum(build.LAUNCHES.values())


@dataclasses.dataclass
class Run:
    """What one run needs: the cell, its configuration and mix, the run's
    arguments and the device."""
    cell: dict
    conf: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = dataclasses.field(default_factory=time.perf_counter)

    @property
    def cuda(self) -> bool:
        return torch.device(self.device).type == "cuda"


def extractor_config(conf: dict):
    from cgx_tpu_torch.config import DEFAULT_CONFIG
    return dataclasses.replace(DEFAULT_CONFIG, **conf.get("extractor", {}))


def load_corpus(conf: dict, with_text: bool):
    """The configuration's corpus arrays, generated on the first run and
    kept in the cache; with ``with_text`` also its cdec text (source,
    target, alignment lines, lex tokens), read as the CLI reads its files."""
    d = cache.corpus_dir(conf)
    arrays = os.path.join(d, "corpus.npz")
    names = ("source.txt", "target.txt", "align.txt", "lex.txt")
    if not os.path.exists(os.path.join(d, "done")):
        os.makedirs(d, exist_ok=True)
        c = gcorpus.make_corpus(conf["corpus"], conf["corpus_seed"])
        c.save(arrays)
        f, e, a, lex = gcorpus.render(c)
        for name, text in zip(names, (f, e, "\n".join(a) + "\n",
                                      " ".join(lex) + "\n")):
            with open(os.path.join(d, name), "w", encoding="ascii") as fh:
                fh.write(text)
        with open(os.path.join(d, "done"), "w") as fh:
            fh.write("ok\n")
    c = gcorpus.Corpus.load(arrays)
    if not with_text:
        return c, None
    texts = []
    for name in names:
        with open(os.path.join(d, name), encoding="ascii") as fh:
            texts.append(fh.read())
    f, e, a, lex = texts
    return c, (f, e, a.splitlines(), lex.split())


def reference_lines(conf: dict, corpus, sentences, precision="float32"):
    """The reference's grammar of ``sentences``; its index built on the
    first run and kept in the cache."""
    from perfbench.reference import config as rconf
    from perfbench.reference import index as rindex
    from perfbench.reference import pipeline as rpipe
    cfg = rconf.from_overrides(conf.get("extractor", {}))
    path = cache.reference_index_path(conf)
    if os.path.exists(path):
        ix = rindex.load(path)
    else:
        ix = rindex.build(corpus, cfg)
        rindex.save(path, ix)
    return rpipe.grammar(ix, sentences, cfg, precision)


def _prepare_serving(run: Run, cfg, timer):
    """``pipeline.prepare`` on the configuration's persisted index, built
    and saved on the first run."""
    from cgx_tpu_torch import pipeline as tpl
    idx = cache.program_index_dir(run.conf)
    fresh = not os.path.exists(os.path.join(idx, "meta.json"))
    corpus, text = load_corpus(run.conf, with_text=fresh)
    if fresh:
        _log(f"building the program's index into {idx}")
        f, e, a, lex = text
        del text
    else:
        f, e, a, lex = "", "", [], []
    prepared = tpl.prepare(f, e, a, lex, cfg, timer, run.device,
                           index_dir=idx)
    return corpus, prepared


def _one_request(prepared, cfg, lines, dest):
    """One request: the grammar of ``lines`` into ``dest``.  Returns the
    time the writer started."""
    from cgx_tpu_torch import pipeline as tpl
    from cgx_tpu_torch.grammar import writer as gw
    res = tpl.run_queries(prepared, lines, cfg)
    tw = time.perf_counter()
    gw.write_grammars(dest, res.queries.qryscount, cfg.is_sample,
                      res.per_query_lines)
    return tw


def _phase_delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0) > 0}


def run_requests(run: Run, workdir: str):
    """Set-up, window and check of a request mix (``kind: requests``, of
    ``batch`` sentences a request).  Returns the record the metric readers
    take, the compared numbers and the counts."""
    cfg = extractor_config(run.conf)
    timer = span_timer(run.device, run.trace)
    corpus, prepared = _prepare_serving(run, cfg, timer)
    sents = gqueries.make_testset(corpus.src, run.conf["testset"],
                                  run.conf["corpus_seed"], run.seed)
    batch = int(run.mix["batch"])
    suffix = "s" if cfg.is_sample else "n"

    # the first use of every kernel library and of the device: the
    # program compiles nothing per shape, so a few sentences suffice (a
    # larger warm-up only lengthens set-up: Europarl's 16 took 55 s)
    warm = os.path.join(workdir, "warm")
    _one_request(prepared, cfg,
                 [" ".join(s) for s in sents[-min(batch, WARM_SENTENCES):]],
                 warm)
    shutil.rmtree(warm)
    _log("set-up " + timer.report())
    if run.cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - run.t0

    requests, served, failed = [], [], 0
    l0 = launches_total()
    prof = trace.profiler() if run.trace else contextlib.nullcontext()
    with prof:
        with _span("bench:window", run.trace):
            t_start = time.perf_counter()
            deadline = t_start + run.seconds
            i = 0
            while True:
                ids = [(i + k) % len(sents) for k in range(batch)]
                dest = os.path.join(workdir, f"r{len(requests)}")
                before = timer.as_dict()
                t0 = time.perf_counter()
                try:
                    with _span("bench:request", run.trace):
                        tw = _one_request(prepared, cfg,
                                          [" ".join(sents[j]) for j in ids],
                                          dest)
                    ok = True
                except Exception as exc:     # counted, and the run goes on
                    _log(f"request {len(requests)} failed: "
                         f"{type(exc).__name__}: {exc}")
                    failed += 1
                    ok, tw = False, time.perf_counter()
                t1 = time.perf_counter()
                requests.append(dict(
                    sentences=batch, wall_s=t1 - t0, write_s=t1 - tw, ok=ok,
                    phases=_phase_delta(before, timer.as_dict())))
                served.append((dest, ids))
                i += batch
                if t1 >= deadline:
                    break
            window_s = time.perf_counter() - t_start
    launches = launches_total() - l0
    peak = torch.cuda.max_memory_allocated() if run.cuda else 0

    # what the window wrote: every file counted, a sample compared
    unanswered, on_disk, by_id = 0, {}, {}
    for dest, ids in served:
        for k, j in enumerate(ids):
            path = os.path.join(dest, f"grammar.{k}.{suffix}")
            if not os.path.exists(path):
                unanswered += 1
            by_id.setdefault(j, path)
    picked = check.sample({j: sents[j] for j in by_id},
                          int(run.conf["check"]["sentences"]), run.seed)
    for j in picked:
        on_disk[j] = check.read_grammar(by_id[j])
    for dest, _ in served:
        shutil.rmtree(dest, ignore_errors=True)
    rec = dict(kind="requests", per=run.mix["per"], requests=requests,
               window_s=window_s, setup_s=setup_s, peak_bytes=peak,
               launches=launches,
               per_count=(sum(r["sentences"] for r in requests)
                          if run.mix["per"] == "sentence" else len(requests)))
    rec["profile"] = prof if run.trace else None
    del prepared
    return rec, dict(corpus=corpus, picked=[sents[j] for j in picked],
                     got=[on_disk[j] for j in picked],
                     unanswered=unanswered, attempted=len(requests),
                     failed=failed)


def run_builds(run: Run, workdir: str):
    """Set-up, window and check of the ``build`` mix."""
    from cgx_tpu_torch import pipeline as tpl
    cfg = extractor_config(run.conf)
    corpus, text = load_corpus(run.conf, with_text=True)
    f, e, a, lex = text
    peak = 0

    def build():
        nonlocal peak
        if run.cuda:
            peak = max(peak, torch.cuda.max_memory_allocated())
        t = span_timer(run.device, run.trace)
        return tpl.prepare(f, e, a, lex, cfg, t, run.device), t

    warm = build()
    del warm
    gc.collect()
    if run.cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - run.t0

    builds, failed, last = [], 0, None
    l0 = launches_total()
    prof = trace.profiler() if run.trace else contextlib.nullcontext()
    with prof:
        with _span("bench:window", run.trace):
            t_start = time.perf_counter()
            deadline = t_start + run.seconds
            while True:
                last = None
                gc.collect()
                t0 = time.perf_counter()
                try:
                    with _span("bench:build", run.trace):
                        last, t = build()
                    phases, ok = t.as_dict(), True
                except Exception as exc:     # counted, and the run goes on
                    _log(f"build {len(builds)} failed: "
                         f"{type(exc).__name__}: {exc}")
                    failed += 1
                    phases, ok = {}, False
                t1 = time.perf_counter()
                builds.append(dict(wall_s=t1 - t0, phases=phases, ok=ok))
                if t1 >= deadline:
                    break
            window_s = time.perf_counter() - t_start
    launches = launches_total() - l0
    if run.cuda:
        peak = max(peak, torch.cuda.max_memory_allocated())

    # the last build's index, judged through a seeded batch's grammar
    sents = gqueries.make_testset(corpus.src, run.conf["testset"],
                                  run.conf["corpus_seed"], run.seed)
    batch = sents[:int(run.mix["check_batch"])]
    dest = os.path.join(workdir, "check")
    unanswered = len(batch)
    if last is not None:
        _one_request(last, cfg, [" ".join(s) for s in batch], dest)
        unanswered = sum(not os.path.exists(
            os.path.join(dest, f"grammar.{k}.s" if cfg.is_sample
                         else f"grammar.{k}.n")) for k in range(len(batch)))
    picked = check.sample(dict(enumerate(batch)),
                          int(run.conf["check"]["sentences"]), run.seed)
    suffix = "s" if cfg.is_sample else "n"
    got = [check.read_grammar(os.path.join(dest, f"grammar.{k}.{suffix}"))
           for k in picked]
    shutil.rmtree(dest, ignore_errors=True)
    rec = dict(kind="build", per="build", builds=builds, window_s=window_s,
               setup_s=setup_s, peak_bytes=peak, launches=launches,
               per_count=sum(b["ok"] for b in builds))
    rec["profile"] = prof if run.trace else None
    del last
    return rec, dict(corpus=corpus, picked=[batch[k] for k in picked],
                     got=got, unanswered=unanswered, attempted=len(builds),
                     failed=failed)


def run_cell(run: Run, bench: dict) -> tuple:
    """The whole run -> (result dict, the compared numbers as text lines),
    or raises when the run must print no result."""
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    try:
        if run.mix["kind"] == "build":
            rec, out = run_builds(run, workdir)
        else:
            rec, out = run_requests(run, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError("modules loaded that the benchmark may not load: "
                           + ", ".join(bad))
    prof = rec.pop("profile")
    if prof is not None:
        rec["device"] = trace.reduce(trace.events_of(prof))
        del prof
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want = reference_lines(run.conf, out["corpus"], out["picked"])
    _log(f"reference {time.perf_counter() - t_ref:.1f} s for "
         f"{len(out['picked'])} sentences")
    off = sum(check.lines_off(g, w) for g, w in zip(out["got"], want))
    # a request or build that raised never answers: not correct
    compared = {"lines_off": {"value": off, "limit": 0},
                "unanswered": {"value": out["unanswered"], "limit": 0},
                "failed": {"value": out["failed"], "limit": 0}}
    correct = all(v["value"] <= v["limit"] for v in compared.values())

    metrics = {}
    for m in spec.metrics(bench, run.cell["name"], run.trace):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if run.cuda:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": int(run.cell["chips"]),
                  "memory_peak_bytes": int(rec["peak_bytes"])}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if run.trace:
        d = rec["device"]
        device["busy_s"] = d["busy_s"]
        device["window_s"] = d["window_s"]
        result["breakdown"] = {"device_ops": d["device_ops"],
                               "idle_gaps": d["idle_gaps"]}
    result["compared"] = compared
    _log(f"{len(out['picked'])} sentences compared with the reference")
    return result, [f"{k} {v['value']} limit {v['limit']}"
                    for k, v in compared.items()]
