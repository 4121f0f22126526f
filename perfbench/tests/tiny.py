"""A configuration small enough for the CPU tests, with the mechanisms of
the real ones (reordering, fan-out, insertions, unseen query words)."""

TINY = {
    "name": "tiny", "source": "test", "corpus_seed": 3,
    "corpus": {"sentences": 3000,
               "source_length": {"mean": 20, "sd": 10, "min": 1, "max": 80},
               "vocab": 400, "zipf": 1.0, "target_vocab": 400,
               "alignment": {"unaligned": 0.1, "fanout": 0.1, "fanout_max": 2,
                             "insert": 0.05, "swap": 0.15, "synonym": 0.1,
                             "verb_final": 0.3}},
    "testset": {"sentences": 40, "block": 16,
                "length": {"mean": 12, "sd": 6, "min": 1, "max": 80},
                "oov": 0.02},
    "check": {"sentences": 3},
    "extractor": {},
}
