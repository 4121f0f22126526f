"""Multi-process execution: the query file split across processes.

Port of ``cgx_tpu/parallel/multihost.py`` (the CLI's ``--coordinator``,
``--num-processes`` and ``--process-id``).  The reference has no
distribution; here each process runs the whole pipeline on its own
contiguous slice of the query file against a replicated corpus index, the
natural layout for one grammar file per query:

* the processes meet through ``torch.distributed`` with the ``gloo``
  backend over TCP (``initialize``); what they exchange is host data
  (process 0's word on the index, the line counts and the phase timings,
  and in the composed mode below the kernels' outputs), so no device
  collective is needed;
* the corpus index is built once, by process 0, and shared through the
  persisted index directory (``--index-dir`` on a common file system): the
  other processes wait for process 0's word that the directory is whole (a
  broadcast in the group, which also fails them at once when process 0
  failed its build) and load it instead of building;
* the queries split into contiguous blocks, so each process writes a
  contiguous range of ``grammar.<i>.{s,n}`` files with their global
  indices;
* ``dp_devices`` composes: each process fans its slice over its own local
  devices (``parallel.localdp``).

With one process this is the plain pipeline.  The composed mode, the JAX
package's too: ``sa_shards > 0`` with several processes.  The index shards
span every process's devices (the global shard list process-major, each
process placing only its own, ``parallel.sharded.placement``), so a corpus
beyond one host's device memory runs.  Every process runs the whole query
file through the device stages (the refinement is a lockstep sum over all
the shards), works only its own shards' items, and each kernel output and
each refinement step's partial sum is summed across the processes with one
gloo ``all_reduce`` of host int32; the host stages run in every process,
and each still writes only its own slice of grammar files.  The build runs
in every process (its gap checks are such sums too), and only process 0
saves an index dir.  ``--sa-shards auto`` with several processes is
refused (``check_layout``), as in the JAX CLI.
"""

from __future__ import annotations

import datetime
import os

import torch.distributed as dist

from cgx_tpu_torch import pipeline as tpl
from cgx_tpu_torch.grammar import writer as gw

# how long a process waits for its peers (the bootstrap, process 0's index
# build, each exchange)
TIMEOUT_S = 600.0


def check_layout(n_processes: int, sa_shards) -> None:
    """Refuses ``sa_shards="auto"`` with several processes: the composed
    mode needs an explicit shard count, as in the JAX CLI."""
    if n_processes > 1 and sa_shards == "auto":
        raise ValueError(
            "--sa-shards auto is single-process only; the composed "
            "multi-process x sharded mode needs an explicit shard count")


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, sa_shards=0) -> bool:
    """Joins the process group at ``coordinator_address`` (HOST:PORT; process
    0 serves it) over gloo; False, and nothing done, without an address.
    A layout that the group cannot run (``check_layout``) is refused before
    joining, so no process waits for a peer that refused it."""
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num-processes and "
                         "--process-id")
    check_layout(num_processes, sa_shards)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    # split-brain guard: a process that joined some other world must not
    # go on to compute a slice nobody else expects
    if dist.get_world_size() != num_processes:
        raise RuntimeError(
            f"the process group at {coordinator_address} has "
            f"{dist.get_world_size()} processes, expected {num_processes}")
    return True


def shutdown() -> None:
    """Leaves the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def query_slice(n_queries: int, process_id: int = None,
                n_processes: int = None):
    """The contiguous query range [lo, hi) of a process (default: this
    one, in this process group)."""
    pid = process_index() if process_id is None else process_id
    pcount = process_count() if n_processes is None else n_processes
    per = -(-n_queries // pcount)
    lo = min(pid * per, n_queries)
    hi = min(lo + per, n_queries)
    return lo, hi


def _index_ready(ok: bool = None) -> bool:
    """Process 0's word (``ok``) that its index directory is whole, or that
    its build failed; every other process waits here for it."""
    word = [ok]
    dist.broadcast_object_list(word, src=0)
    return bool(word[0])


def _phase_max_allgather(timing) -> dict:
    """Per phase, the maximum over all processes (the critical path of
    recordTime's buckets, Start.cu:392-469, for a multi-process run).  The
    processes' phase sets differ (process 0 builds, the others load), so each
    sends its whole dict."""
    gathered = [None] * process_count()
    dist.all_gather_object(gathered, timing.as_dict(children=False))
    agg: dict = {}
    for phases in gathered:
        for k, v in phases.items():
            agg[k] = max(agg.get(k, 0.0), float(v))
    return agg


def run_multihost(f_lines, e_lines, a_lines, lex_tokens, q_lines, dest_dir,
                  cfg, index_dir=None, sa_shards=0, dp_devices=0,
                  device="cuda"):
    """Runs the pipeline on this process's query slice (in the composed
    mode, on every query) and writes its slice's grammar files under their
    global query indices.  Returns (lo, hi, PipelineResult, the grammar
    lines of all processes); with several processes the result's timer
    also holds ``global_phase_max``."""
    several = process_count() > 1
    check_layout(process_count(), sa_shards)
    first = process_index() == 0
    composed = several and bool(sa_shards)
    # process 0 builds and saves the index dir, and only then do the others
    # load it; a dir that is whole already they all load at once.  In the
    # composed mode every process builds (its sums need all of them)
    shared = several and bool(index_dir) and not composed
    if shared and not first and not _index_ready():
        raise RuntimeError(f"process 0 did not build the index at "
                           f"{index_dir}")
    if shared and first and os.path.exists(os.path.join(index_dir,
                                                        "meta.json")):
        _index_ready(True)
        shared = False
    try:
        prep = tpl.prepare(f_lines, e_lines, a_lines, lex_tokens, cfg, None,
                           device, sa_shards=sa_shards, index_dir=index_dir,
                           dp_devices=dp_devices, save_index=first)
    except BaseException:
        if shared and first:
            _index_ready(False)
        raise
    if shared and first:
        _index_ready(True)
    lo, hi = query_slice(len(q_lines))
    res = tpl.run_queries(prep, q_lines if composed else q_lines[lo:hi], cfg)
    gw.write_grammars(dest_dir, hi - lo, cfg.is_sample,
                      res.per_query_lines[lo:hi] if composed
                      else res.per_query_lines, first=lo)
    total_lines = res.counters["total_lines"]
    if several and not composed:
        counts = [None] * process_count()
        dist.all_gather_object(counts, total_lines)
        total_lines = sum(counts)
    if several:
        res.timing.global_phase_max = _phase_max_allgather(res.timing)
    return lo, hi, res, total_lines
