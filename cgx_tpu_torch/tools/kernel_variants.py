"""Variants of the extraction kernels side by side on the card.

    python3 -m cgx_tpu_torch.tools.kernel_variants NAME=DIR [NAME=DIR ...]

Each DIR holds a full copy of ``cgx_tpu_torch/csrc`` (one variant's
sources).  The tool builds each variant's ``onegap.cu``, ``twogap.cu`` and
``contig.cu`` with the port's nvcc flags and prints ptxas's report and an
opcode histogram of each kernel's SASS (``cuobjdump -sass``).  It then runs
``chip_smoke.py``'s medium run and its europarl run over four shards,
keeping each kernel's largest launch, and times every variant on them, in
turns (the variants in order, then in reverse), by CUDA events and by the
device's own clock (``chip_smoke._device_ms``): A7, A7 on a shard's views
(A7v), A8, A8v, A8 on one item, A6 and B3c.  Every output is checked
against the plain version first; a variant that differs is reported and
dropped.  Run from the repository root on a machine with a card.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from cgx_tpu_torch.extract import device as xdev
from cgx_tpu_torch.kernels import build as kb

SOURCES = ("onegap", "twogap", "contig")


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
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                sass))
        print(json.dumps({"variant": name, "source": f, "ptxas": [
            ln.strip() for ln in txt.splitlines()
            if "registers" in ln or "spill" in ln],
            "sass_total": sum(ops.values()),
            "sass_top": ops.most_common(14)}), flush=True)
        lib = ctypes.CDLL(so)
        for fn, argt in kb.SIGNATURES[f].items():
            getattr(lib, fn).argtypes = argt
            getattr(lib, fn).restype = ctypes.c_int
        libs[f] = lib
    return libs


def launch(libs: dict, k: str, args) -> torch.Tensor:
    """Kernel ``k`` of one variant on a captured call's arguments."""
    if k == "A6":
        ref, sa, rlp, lr, pos, lm, mrs, msym = args
        out = torch.empty((8, pos.shape[0]), dtype=torch.int32,
                          device=pos.device)
        rc = libs["contig"].cgx_contig(
            kb.ptr(ref), ref.shape[0], kb.ptr(sa), sa.shape[0], kb.ptr(rlp),
            rlp.shape[0], kb.ptr(lr), lr.shape[0], kb.ptr(pos), kb.ptr(lm),
            pos.shape[0], mrs, msym, kb.ptr(out), kb.stream(pos.device))
    elif k == "B3c":
        ref, rlp, lr, cs, lm, mrs, msym = args
        out = torch.empty((8, cs.shape[0]), dtype=torch.int32,
                          device=cs.device)
        rc = libs["contig"].cgx_contig_pos(
            *kb.view(ref), *kb.view(rlp), *kb.view(lr), kb.ptr(cs),
            kb.ptr(lm), cs.shape[0], mrs, msym, kb.ptr(out),
            kb.stream(cs.device))
    elif k.startswith("A7"):
        ref, rlp, lr, cs, fe, sl, el, mrs, msym = args
        out = torch.empty((6, cs.shape[0]), dtype=torch.int32,
                          device=cs.device)
        rc = libs["onegap"].cgx_onegap(
            *kb.view(ref), *kb.view(rlp), *kb.view(lr), kb.ptr(cs),
            kb.ptr(fe), kb.ptr(sl), kb.ptr(el), cs.shape[0], mrs, msym,
            kb.ptr(out), kb.stream(cs.device))
    else:
        ref, rlp, lr, cs, fe, se, sl, el, cl, mrs = args
        out = torch.empty((2, cs.shape[0]), dtype=torch.int32,
                          device=cs.device)
        rc = libs["twogap"].cgx_twogap(
            *kb.view(ref), *kb.view(rlp), *kb.view(lr), kb.ptr(cs),
            kb.ptr(fe), kb.ptr(se), kb.ptr(sl), kb.ptr(el), kb.ptr(cl),
            cs.shape[0], mrs, kb.ptr(out), kb.stream(cs.device))
    kb.check(k, rc)
    return out


def main(argv=None) -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    variants = [a.split("=", 1) for a in (argv or sys.argv[1:])]
    libs = {name: build(name, src, f"build/kernel_variants/{name}")
            for name, src in variants}
    with open(cs.GOLDEN, encoding="utf-8") as fh:
        golden = json.load(fh)
    with cs.Capture() as cap:
        for size, lcp, shards, cols, expect, forbid in (cs.RUNS[0],
                                                        cs.RUNS[2]):
            cs.run_e2e(size, "cuda", cap, golden, expect, lcp, forbid,
                       shards, cols)
    rows = {k: cap.calls[k][1] for k in ("A7", "A7v", "A8", "A8v")}
    one = list(rows["A8"])
    one[3:9] = [a[:1].contiguous() for a in one[3:9]]
    rows["A8@1"] = tuple(one)
    rows["A6"], rows["B3c"] = cap.calls["A6"][1], cap.calls["B3c"][1]
    plains = {"A6": xdev.contig_plain, "B3c": xdev.contig_pos_plain}
    want = {k: plains.get(k, xdev.onegap_plain if k.startswith("A7")
                          else xdev.twogap_plain)(*a)
            for k, a in rows.items()}
    dropped = set()
    names = [name for name, _ in variants]
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            if name in dropped:
                continue
            res = {}
            for k, args in rows.items():
                got = launch(libs[name], k, args)
                torch.cuda.synchronize()
                if not torch.equal(got, want[k]):
                    print(json.dumps({"variant": name, "row": k,
                                      "bit_equal": False}), flush=True)
                    dropped.add(name)
                    break
                ms, reps = cs._time_ms(lambda: launch(libs[name], k, args),
                                       "cuda")
                dev = cs._device_ms(lambda: launch(libs[name], k, args),
                                    reps)
                res[k] = {"items": int(got.shape[1]), "ms": ms,
                          "device_ms": dev["device_ms"]}
            if name not in dropped:
                print(json.dumps({"variant": name, "turn": turn, **res}),
                      flush=True)
    return 1 if dropped else 0


if __name__ == "__main__":
    sys.exit(main())
