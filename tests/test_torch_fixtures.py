"""The toy and real fixtures exist, complete, before any test runs.

``tests/fixtures/`` is not committed.  The pytest fixtures ``toy_fixture``
and ``real_fixture`` (tests/conftest.py) generate a fixture whenever its
``corpus.f`` is missing; under pytest-xdist several workers would do that at
once, each truncating and rewriting files that another worker is reading.
pytest-xdist has every worker collect every test file before it schedules the
first test, so this module builds each missing fixture while it is imported:
into a temporary sibling directory, moved into place with one ``os.rename``,
under an exclusive lock on ``tests/fixtures/.lock``.  The existence check in
conftest.py then always finds complete files and never regenerates them.

The JAX package's native library (``cgx_tpu/preproc/native_build.py``)
compiles itself on first use straight into its final path, with no lock
across processes, and a worker that loads another worker's half-written
library keeps ``load_native()`` at None for the rest of its run (its
callers then skip).  So this module also calls ``load_native()`` once while
it is imported, under the same lock: the first worker compiles, every later
one finds the library complete, and no worker compiles it while the tests
run.
"""

import fcntl
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
GENERATORS = {"toy": "make_fixture.py", "real": "make_realfixture.py"}


def ensure_fixture(name: str) -> pathlib.Path:
    """Build ``tests/fixtures/<name>`` unless it is complete already."""
    dest = FIXTURES / name
    if (dest / "corpus.f").exists():
        return dest
    FIXTURES.mkdir(parents=True, exist_ok=True)
    with open(FIXTURES / ".lock", "w", encoding="utf-8") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (dest / "corpus.f").exists():       # another process built it
            return dest
        tmp = pathlib.Path(tempfile.mkdtemp(prefix=f".{name}-", dir=FIXTURES))
        try:
            subprocess.run([sys.executable,
                            str(ROOT / "tools" / GENERATORS[name]),
                            "--out", str(tmp)],
                           check=True, stdout=subprocess.DEVNULL)
            if dest.exists():                  # a partial directory
                shutil.rmtree(dest)
            try:
                os.rename(tmp, dest)
            except OSError:                    # lost the rename: keep theirs
                pass
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return dest


def ensure_native():
    """Build the JAX package's native library (if it is missing or older
    than its source) and load it, one process at a time."""
    FIXTURES.mkdir(parents=True, exist_ok=True)
    with open(FIXTURES / ".lock", "w", encoding="utf-8") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        from cgx_tpu.preproc.native_build import load_native
        load_native()


for _name in GENERATORS:
    ensure_fixture(_name)
ensure_native()


def _line_count(path: pathlib.Path) -> int:
    with open(path, encoding="utf-8") as fh:
        return sum(1 for _ in fh)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_fixture_is_complete(name):
    d = FIXTURES / name
    n = _line_count(d / "corpus.f")
    assert n > 0
    assert _line_count(d / "corpus.e") == n
    assert _line_count(d / "corpus.a") == n
    assert (d / "query.f").read_text(encoding="utf-8").strip()
    assert (d / "lex.txt").stat().st_size > 0
