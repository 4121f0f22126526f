"""Cache keys: the program's index key changes with any source file of the
program, and nothing else of the tree moves it."""

import os
import shutil

from perfbench import cache
from perfbench.tests.tiny import TINY


def test_tree_hash_follows_source_files(tmp_path):
    for f in ("a.py", "k/b.cu", "k/c.cuh", "n/d.cpp"):
        p = tmp_path / f
        p.parent.mkdir(exist_ok=True)
        p.write_text(f)
    base = cache.tree_hash(str(tmp_path), cache.PROGRAM_SOURCES)
    (tmp_path / "notes.txt").write_text("x")
    os.makedirs(tmp_path / "__pycache__")
    (tmp_path / "__pycache__" / "a.py").write_text("x")
    assert cache.tree_hash(str(tmp_path), cache.PROGRAM_SOURCES) == base
    for f in ("a.py", "k/b.cu", "k/c.cuh", "n/d.cpp"):
        p = tmp_path / f
        old = p.read_text()
        p.write_text(old + " ")
        assert cache.tree_hash(str(tmp_path), cache.PROGRAM_SOURCES) != base
        p.write_text(old)
    assert cache.tree_hash(str(tmp_path), cache.PROGRAM_SOURCES) == base


def test_program_index_dir_moves_with_the_program(tmp_path, monkeypatch):
    prog = tmp_path / cache.PROGRAM
    shutil.copytree(os.path.join(cache.ROOT, cache.PROGRAM), prog,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(cache, "ROOT", str(tmp_path))
    first = cache.program_index_dir(TINY)
    assert first == cache.program_index_dir(TINY)
    cu = prog / "csrc" / "scan.cu"
    cu.write_text(cu.read_text() + "\n")
    assert cache.program_index_dir(TINY) != first
    other = dict(TINY, corpus_seed=4)
    assert cache.corpus_dir(other) != cache.corpus_dir(TINY)
    assert cache.reference_index_path(TINY).startswith(cache.CACHE)
