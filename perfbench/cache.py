"""The benchmark's cache inside the checkout (``perfbench/cache/``): the
generated corpus, the program's persisted index and the reference's index.

Keys are content hashes, so no run loads what another version made: the
corpus by its configuration file and the generator's sources, the
program's index by the corpus key and every source file of the program,
the reference's by the corpus key and the reference's sources.  Paths are
fixed by the keys alone, so later runs of a checkout find them.
"""

from __future__ import annotations

import hashlib
import json
import os

from perfbench.spec import HERE, ROOT

CACHE = os.path.join(HERE, "cache")
PROGRAM = "cgx_tpu_torch"
PROGRAM_SOURCES = (".py", ".cu", ".cuh", ".cpp")


def tree_hash(directory: str, suffixes) -> str:
    """SHA-256 over every file under ``directory`` with one of
    ``suffixes``, by relative path and content."""
    h = hashlib.sha256()
    for dirpath, dirnames, files in os.walk(directory):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(tuple(suffixes)):
                p = os.path.join(dirpath, f)
                h.update(os.path.relpath(p, directory).encode())
                with open(p, "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()


def _key(*parts: str) -> str:
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]


def corpus_key(conf: dict) -> str:
    """The configuration (as its file holds it) and the generator's code."""
    return _key(json.dumps(conf, sort_keys=True),
                tree_hash(os.path.join(HERE, "gen"), (".py",)))


def corpus_dir(conf: dict) -> str:
    return os.path.join(CACHE, conf["name"], f"corpus-{corpus_key(conf)}")


def program_index_dir(conf: dict) -> str:
    key = _key(corpus_key(conf),
               tree_hash(os.path.join(ROOT, PROGRAM), PROGRAM_SOURCES))
    return os.path.join(CACHE, conf["name"], f"index-{key}")


def reference_index_path(conf: dict) -> str:
    key = _key(corpus_key(conf),
               tree_hash(os.path.join(HERE, "reference"), (".py",)))
    return os.path.join(CACHE, conf["name"], f"ref-{key}.npz")
