"""setup_s: process start to the first timed request or build (imports,
kernel libraries, corpus, index load or build, engine context, warm-up)."""


def read(rec):
    return rec["setup_s"]
