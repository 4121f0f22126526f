"""The control of the comparison that decides ``correct``: the reference
put in the program's place and computed in the precision below the one the
extractor states (every feature rounded to bfloat16 instead of float32),
judged against the float32 reference on the sentences a run of the cell
checks.  It has to come out not correct; each seed's compared number is
printed as one JSON line.

    python3 perfbench/control.py --workload <name> --seeds <n>,<n>,...

Runs on the host alone (the reference is numpy), at the cell's own sizes;
the reference's index comes from the cache a run of the cell filled, or is
built.  The benchmark's runs never run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control_lines_off(conf: dict, mix: dict, seed: int, served: int) -> dict:
    """lines_off of the bfloat16 reference against the float32 one, on the
    check sample of a run that served the first ``served`` test
    sentences of ``seed``'s order."""
    from perfbench import check, harness
    from perfbench.gen import queries as gq
    corpus, _ = harness.load_corpus(conf, with_text=False)
    sents = gq.make_testset(corpus.src, conf["testset"], conf["corpus_seed"],
                            seed)
    if mix["kind"] == "build":
        pool = dict(enumerate(sents[:int(mix["check_batch"])]))
    else:
        pool = {j: sents[j % len(sents)] for j in range(served)}
    picked = [pool[j] for j in check.sample(
        pool, int(conf["check"]["sentences"]), seed)]
    want = harness.reference_lines(conf, corpus, picked)
    got = harness.reference_lines(conf, corpus, picked, "bfloat16")
    off = sum(check.lines_off(g, w) for g, w in zip(got, want))
    return {"seed": seed, "lines_off": off,
            "lines": sum(len(w) for w in want), "sentences": len(picked)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--served", type=int, default=768,
                   help="test sentences a run serves (the sample's pool)")
    args = p.parse_args(argv)
    from perfbench import spec
    cell = spec.cell(spec.benchmark(), args.workload)
    conf, mix = spec.config(cell["config"]), spec.mix(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = control_lines_off(conf, mix, seed % (1 << 64), args.served)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
