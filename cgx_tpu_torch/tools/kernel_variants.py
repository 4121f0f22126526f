"""Variants of the port's kernels side by side on the card.

    python3 -m cgx_tpu_torch.tools.kernel_variants NAME=DIR [NAME=DIR ...]

Each DIR holds a full copy of ``cgx_tpu_torch/csrc`` (one variant's
sources). The tool builds each variant's ``onegap.cu``, ``twogap.cu``,
``contig.cu``, ``lcp.cu``, ``maxlex.cu``, ``dist.cu``, ``refine.cu``,
``sharded.cu``, ``scan.cu`` and ``probe.cu`` with the port's nvcc flags and
prints ptxas's report and an opcode histogram of each library's SASS
(``cuobjdump -sass``) and each kernel's static SASS instruction count (for
a body without loops, such as A9's, about what one warp issues). It then runs ``chip_smoke.py``'s
medium run, its europarl run with the LCP passes, the query-DP step and A9
on europarl's lexicon as dense tables (A9L), its europarl run over four
shards and C1p on A3's items as columns, keeping each kernel's largest
launch, and times every variant on them, in turns (the variants in order,
then in reverse), by CUDA events and by the device's own clock
(``chip_smoke._device_ms``): A7, A7 on a shard's views (A7v), A8, A8v, A8 on
one item, A6, B3c, B1p1, B1p2, B4, A9, A9 on one rule (the launch's fixed
cost), A9L, A10, A1, B2r, A3, A3 on one item, B3p, C1p, the gather
probe's P1 and P2 on its two inputs (europarl's A2b scan starts, and its
defaults as P1@d and P2@d), and B2s+B2t@1 and @2: the round form's whole
dispatch (every B2s and B2t launch and the sums between them) on
europarl's two pass-1/2 dispatches (the four-shard run's two B2r calls)
over ``["cuda:0"] * 4``. Each row runs through the port's own wrapper
with the variant's library in place of the built one; the round form of a
``sharded.cu`` from before the tree step (no ``kTreeNodes``: one
bisection level a step, K steps a lower bound) runs through its own C
entries as its wrapper called them (``round_stepwise``). Every output is
checked against the plain version first (B2r's, for the round form); a
variant that differs is reported and dropped. Run from the repository root
on a machine with a card.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys

import dataclasses

import numpy as np
import torch

from cgx_tpu_torch.engine import on
from cgx_tpu_torch.extract import device as xdev
from cgx_tpu_torch.features import maxlex as ml
from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.parallel import dist
from cgx_tpu_torch.parallel import sharded as shx
from cgx_tpu_torch.search import lookup, passes
from cgx_tpu_torch.tools import gather_probe as gp

SOURCES = ("onegap", "twogap", "contig", "lcp", "maxlex", "dist", "refine",
           "sharded", "scan", "probe")
# row -> (the port's wrapper, its plain version); A7v, A8v, A8@1, A9@1 and
# A3@1 run A7's, A8's, A9's and A3's
ROWS = {"A7": (xdev.onegap, xdev.onegap_plain),
        "A7v": (xdev.onegap, xdev.onegap_plain),
        "A8": (xdev.twogap, xdev.twogap_plain),
        "A8v": (xdev.twogap, xdev.twogap_plain),
        "A8@1": (xdev.twogap, xdev.twogap_plain),
        "A6": (xdev.contig, xdev.contig_plain),
        "B3c": (xdev.contig_pos, xdev.contig_pos_plain),
        "B1p1": (passes.pass1, passes.pass1_plain),
        "B1p2": (passes.pass2, passes.pass2_plain),
        "B4": (dist.dp_step, dist.dp_step_plain),
        "A9": (ml.accum_dense, ml.accum_dense_plain),
        "A9@1": (ml.accum_dense, ml.accum_dense_plain),
        "A9L": (ml.accum_dense, ml.accum_dense_plain),
        "A10": (ml.accum_range, ml.accum_range_plain),
        "A1": (passes.refine_chunk, passes.refine_chunk_plain),
        "B2r": (shx.refine_sharded, shx.refine_sharded_plain),
        "A3": (lookup.pcs, lookup.pcs_plain),
        "A3@1": (lookup.pcs, lookup.pcs_plain),
        "B3p": (lookup.pcs_items, lookup.pcs_items_plain),
        "C1p": (lookup.pcs_cols, lookup.pcs_cols_plain),
        "P1": (lambda r, p: probe("P1", r, p), gp.gather_sum_plain),
        "P1@d": (lambda r, p: probe("P1", r, p), gp.gather_sum_plain),
        "P2": (lambda r, p: probe("P2", r, p), gp.gather_rows_plain),
        "P2@d": (lambda r, p: probe("P2", r, p), gp.gather_rows_plain)}


def round_dispatch(sidx, qtok, toks, sls, lo, hi, d0: int, depths: int):
    """One dispatch of the round form over the index on a device list
    ``sidx`` (host lanes), through the installed variant's library: the
    port's ``refine_round``, or ``round_stepwise`` for a library from
    before the tree step."""
    fn = (round_stepwise if getattr(kb.library("sharded"), "stepwise", False)
          else shx.refine_round)
    return fn(sidx, qtok, toks, sls, lo, hi, d0, depths)


def round_plain(sidx, qtok, toks, sls, lo, hi, d0: int, depths: int):
    """B2r's plain version (JAX's bisection through the shards) on the same
    lanes, on the index's home device."""
    return shx.refine_sharded_plain(sidx, qtok, *on(sidx.device, toks, sls,
                                                    lo, hi), d0, depths)


# the C signatures of B2s and B2t before the tree step
_STEPWISE = {"cgx_refine_step": kb.SIGNATURES["sharded"]["cgx_refine_step"],
             "cgx_token_partial": [ctypes.c_void_p] + [ctypes.c_int] * 4
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p] * 2}


def round_stepwise(sidx, qtok, toks, sls, lo, hi, d0: int, depths: int):
    """The round form as it ran before the tree step: K = ``round_steps``
    bisection steps a lower bound, T = 2 depths K steps, each a B2s launch
    on every shard (part of the SA word at each lane's midpoint, int32
    [n]), their sum, a B2t launch (part of the token there), their sum."""
    lib = kb.library("sharded")
    for fn, argt in _STEPWISE.items():
        getattr(lib, fn).argtypes = argt
    n, dev = len(toks), sidx.device
    K = shx.round_steps(lo, hi)
    T = 2 * depths * K
    toks_t, sls_t = on(dev, toks, sls)
    lanes = {s: (torch.from_numpy(np.stack([lo, hi, lo, hi]).astype(
        np.int32)).to(dev), torch.zeros((n, depths), dtype=torch.int32,
                                        device=dev),
        torch.zeros((n, depths), dtype=torch.int32, device=dev))
        for s in sidx.local_shards()}
    tok = torch.zeros(n, dtype=torch.int32, device=dev)
    for g in range(T + 1):
        parts = []
        for s, (st, ups, downs) in lanes.items():
            rstart, rcount = (int(x) for x in sidx.rmeta[s])
            out = torch.empty(n, dtype=torch.int32, device=dev)
            kb.launch("sharded", "cgx_refine_step", dev,
                      kb.ptr(sidx.sa_l[s]), sidx.sa_l[s].shape[0], rstart,
                      rcount, kb.ptr(qtok), qtok.shape[0], kb.ptr(toks_t),
                      kb.ptr(sls_t), kb.ptr(st), kb.ptr(ups), kb.ptr(downs),
                      kb.ptr(tok), n, g, K, d0, depths, kb.ptr(out))
            parts.append(out)
        if g == T:
            break
        sa_sum = shx._sum_parts(sidx, parts)[dev]
        parts = []
        for s, (st, _, _) in lanes.items():
            soff, olo, ohi = (int(x) for x in sidx.smeta[s])
            out = torch.empty(n, dtype=torch.int32, device=dev)
            kb.launch("sharded", "cgx_token_partial", dev,
                      kb.ptr(sidx.ref_l[s]), sidx.ref_l[s].shape[0], soff,
                      olo, ohi, kb.ptr(st), kb.ptr(sa_sum), n,
                      d0 + g // K // 2, kb.ptr(out))
            parts.append(out)
        tok = shx._sum_parts(sidx, parts)[dev]
    st, ups, downs = lanes[sidx.local_shards()[0]]
    return ups, downs, st[0], st[1]



def probe(kernel: str, ref, pos):
    """P1 or P2 through the port's wrapper, or, for a variant whose probe
    library predates ``cgx_probe_sum`` (``csrc/`` before the persistent
    walk: one warp an item, P1 adding into a zeroed word), through its own
    C entries as its wrapper called them."""
    lib = kb.library("probe")
    if hasattr(lib, "cgx_probe_sum"):
        return (gp.gather_sum if kernel == "P1" else gp.gather_rows)(ref,
                                                                     pos)
    n, dev = pos.shape[0], pos.device
    out = (torch.zeros(1, dtype=torch.int32, device=dev) if kernel == "P1"
           else torch.empty((n, gp.W), dtype=torch.int32, device=dev))
    fn = "cgx_gather_sum" if kernel == "P1" else "cgx_gather_rows"
    getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p]
    kb.launch("probe", fn, dev, kb.ptr(ref), ref.shape[0], kb.ptr(pos), n,
              kb.ptr(out))
    return out[0] if kernel == "P1" else out


def build(name: str, src: str, out: str) -> dict:
    """Compile a variant's sources -> {source: ctypes library}."""
    nvcc = kb._nvcc()
    os.makedirs(out, exist_ok=True)
    procs = {f: subprocess.Popen(
        [nvcc, *kb.NVCC_FLAGS, "-o", f"{out}/lib{f}.so", f"{src}/{f}.cu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for f in SOURCES}
    libs = {}
    for f, p in procs.items():
        txt = p.communicate()[0]
        if p.returncode:
            sys.exit(f"{name}/{f}.cu: nvcc failed\n{txt[-3000:]}")
        so = os.path.abspath(f"{out}/lib{f}.so")
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", so],
            capture_output=True, text=True).stdout
        op = re.compile(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in op.finditer(sass))
        # per kernel: the text from its "Function :" line to the next
        parts = re.split(r"Function : (\S+)", sass)[1:]
        per_kernel = {
            (re.findall(r"[a-z][a-z0-9_]*_kernel", fn) or [fn])[0]:
            len(op.findall(body)) for fn, body in zip(parts[::2], parts[1::2])}
        print(json.dumps({"variant": name, "source": f, "ptxas": [
            ln.strip() for ln in txt.splitlines()
            if "registers" in ln or "spill" in ln],
            "sass_total": sum(ops.values()), "sass_kernels": per_kernel,
            "sass_top": ops.most_common(14)}), flush=True)
        lib = ctypes.CDLL(so)
        if f == "sharded":      # a round form from before the tree step
            with open(f"{src}/sharded.cu", encoding="utf-8") as fh:
                lib.stepwise = "kTreeNodes" not in fh.read()
        for fn, argt in kb.SIGNATURES[f].items():
            if not hasattr(lib, fn):    # an older probe library: probe()
                continue
            getattr(lib, fn).argtypes = argt
            getattr(lib, fn).restype = ctypes.c_int
        lib.cgx_error_string.argtypes = [ctypes.c_int]
        lib.cgx_error_string.restype = ctypes.c_char_p
        libs[f] = lib
    return libs


@contextlib.contextmanager
def installed(libs: dict):
    """The port's wrappers launch the variant's libraries inside."""
    saved = dict(kb._libs)
    kb._libs.update(libs)
    try:
        yield
    finally:
        kb._libs.clear()
        kb._libs.update(saved)


def capture_rows() -> dict:
    """Each row's items and captured arguments from ``chip_smoke.py``'s
    runs -> {row: (items, args)}."""
    import chip_smoke as cs
    with open(cs.GOLDEN, encoding="utf-8") as fh:
        golden = json.load(fh)
    dispatches = []        # the four-shard run's B2r calls, in order
    real = shx.refine_sharded

    def keep(*args):
        dispatches.append(args)
        return real(*args)
    shx.refine_sharded = keep
    try:
        with cs.Capture() as cap:
            for size, lcp, shards, cols, expect, forbid in cs.RUNS[:3]:
                dispatches.clear()
                _, res, _, _ = cs.run_e2e(size, "cuda", cap, golden, expect,
                                          lcp, forbid, shards, cols)
                if size == "europarl" and not shards:
                    cs.check_lcp_passes(res)
                    cs.check_query_dp(res, cap)
                    cs.check_dense_large(res, cap)
                if shards:
                    sidx = res.index
                del res
            cs.check_pcs_cols(cap)
    finally:
        shx.refine_sharded = real
    rows = {k: cap.calls[k] for k in ROWS if k in cap.calls}
    # the round form over the same shards placed on the card four times
    listed = dataclasses.replace(
        sidx, devices=[sidx.device] * sidx.S, listed=True, _shard_tables={},
        _qtok=None)
    for j, (_, qtok, toks, sls, lo, hi, d0, depths) in enumerate(
            dispatches, 1):
        ROWS[f"B2s+B2t@{j}"] = (round_dispatch, round_plain)
        rows[f"B2s+B2t@{j}"] = (toks.shape[0], (
            listed, qtok, *(x.cpu().numpy() for x in (toks, sls, lo, hi)),
            d0, depths))
    probes = cs.probe_inputs(cap)
    for k in ("P1", "P2"):
        for suffix, name in (("", "europarl_A2b"), ("@d", "defaults")):
            ref, pos = probes[name]
            rows[k + suffix] = (pos.shape[0], (ref, pos))
    one = list(rows["A8"][1])
    one[3:9] = [a[:1].contiguous() for a in one[3:9]]
    rows["A8@1"] = (1, tuple(one))
    one = list(rows["A9"][1])
    one[4:11] = [a[:1].contiguous() for a in one[4:11]]
    rows["A9@1"] = (1, tuple(one))
    one = list(rows["A3"][1])
    one[4] = 1
    rows["A3@1"] = (1, tuple(one))
    return rows


def main(argv=None) -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    variants = [a.split("=", 1) for a in (argv or sys.argv[1:])]
    libs = {name: build(name, src, f"build/kernel_variants/{name}")
            for name, src in variants}
    # the device clock reads every variant's kernels, whatever their names
    kernels = set(cs._kernel_names())
    for _, src in variants:
        for f in os.listdir(src):
            if f.endswith(".cu"):
                with open(os.path.join(src, f), encoding="utf-8") as fh:
                    kernels |= set(re.findall(r"(\w+)\s*<<<", fh.read()))
    cs._kernel_names = lambda: sorted(kernels)
    rows = capture_rows()

    def outputs(fn, args):
        out = fn(*args)
        out = out if isinstance(out, (tuple, list)) else (out,)
        return [o.view(torch.int32) if o.dtype == torch.float32 else o
                for o in out]
    want = {k: outputs(ROWS[k][1], a) for k, (_, a) in rows.items()}
    dropped = set()
    names = [name for name, _ in variants]
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            if name in dropped:
                continue
            res = {}
            with installed(libs[name]):
                for k, (items, args) in rows.items():
                    kernel = ROWS[k][0]
                    got = outputs(kernel, args)
                    torch.cuda.synchronize()
                    if not all(torch.equal(g, w)
                               for g, w in zip(got, want[k])):
                        print(json.dumps({"variant": name, "row": k,
                                          "bit_equal": False}), flush=True)
                        dropped.add(name)
                        break
                    ms, reps = cs._time_ms(lambda: kernel(*args), "cuda")
                    dev = cs._device_ms(lambda: kernel(*args), reps)
                    res[k] = {"items": items, "ms": ms,
                              "device_ms": dev["device_ms"]}
            if name not in dropped:
                print(json.dumps({"variant": name, "turn": turn, **res}),
                      flush=True)
    return 1 if dropped else 0


if __name__ == "__main__":
    sys.exit(main())
