"""Multi-process query sharding in the port
(``cgx_tpu_torch/parallel/multihost.py``) on the CPU: the query slices
against the JAX package's, the atomic ``meta.json`` write, two real
processes of the port's CLI joined over gloo (with and without
``--dp-devices 2``) byte-compared with the JAX CLI's run and the port's
one-process run, a failed build of process 0 failing its peer at once, and
the refusals (the composed multi-process x sharded mode, ``auto`` across
processes)."""

import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from cgx_tpu import cli as jcli  # noqa: E402
from cgx_tpu.parallel import multihost as jmh  # noqa: E402
from cgx_tpu_torch import cli  # noqa: E402
from cgx_tpu_torch import pipeline as tpl  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.parallel import multihost  # noqa: E402
from cgx_tpu_torch.preproc import corpus as cp  # noqa: E402
from cgx_tpu_torch.preproc import index_io  # noqa: E402

REPO = pathlib.Path(__file__).parent.parent


def _inputs(d):
    return (cp.read_lines(str(d / "corpus.f")), cp.read_lines(str(d / "corpus.e")),
            cp.read_lines(str(d / "corpus.a")), cp.read_tokens(str(d / "lex.txt")),
            cp.read_lines(str(d / "query.f")))


def test_query_slice_equals_jax():
    for n in (0, 1, 2, 7, 8, 64, 65):
        for count in (1, 2, 3, 4, 8):
            got = [multihost.query_slice(n, pid, count)
                   for pid in range(count)]
            assert got == [jmh.query_slice(n, pid, count)
                           for pid in range(count)], (n, count)
            # contiguous and covering
            assert got[0][0] == 0 and got[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    # one process, no group: the whole file
    assert multihost.query_slice(5) == (0, 5)
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)


def test_meta_json_appears_only_whole(toy_fixture, tmp_path, monkeypatch):
    """While meta.json is being written, nothing is under its name; after
    the save it loads and no temporary file is left."""
    art, _, _, _ = tpl.build_artifact(*_inputs(toy_fixture)[:4],
                                      ExtractorConfig(precompute_count=30),
                                      device="cpu")
    final = tmp_path / "meta.json"
    seen = []
    real_dump = json.dump

    def dump(obj, fh):
        text = json.dumps(obj)
        half = len(text) // 2
        fh.write(text[:half])
        fh.flush()
        seen.append(final.exists())     # half written: not visible
        fh.write(text[half:])
    monkeypatch.setattr(index_io.json, "dump", dump)
    index_io.save(str(tmp_path), art, ExtractorConfig(precompute_count=30))
    monkeypatch.setattr(index_io.json, "dump", real_dump)
    assert seen == [False]
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["arrays.npz", "meta.json"]
    _, cfg = index_io.load(str(tmp_path))
    assert cfg == ExtractorConfig(precompute_count=30)


def test_only_process_zero_saves(toy_fixture, tmp_path):
    """A process other than 0 builds its index without saving it
    (``save_index=False``, as ``run_multihost`` passes it)."""
    _, _, t, _ = tpl.build_artifact(*_inputs(toy_fixture)[:4],
                                    ExtractorConfig(precompute_count=30),
                                    device="cpu", index_dir=str(tmp_path),
                                    save_index=False)
    assert "indexsave" not in t.as_dict()
    assert not (tmp_path / "meta.json").exists()


def test_composed_mode_is_refused(toy_fixture, tmp_path, monkeypatch,
                                  capsys):
    """sa_shards with several processes is refused with one line naming
    ROADMAP item 10b, before joining and before any work: by
    ``initialize`` (the CLI's one error line, ``auto`` included) and by
    ``run_multihost`` in a group of several; a coordinator without its
    counts is refused too."""
    F = toy_fixture
    files = [str(F / n) for n in ("corpus.f", "query.f", "corpus.e",
                                  "corpus.a", "lex.txt")]
    # the address is never contacted: every refusal comes before joining
    coord = ["--device", "cpu", "--coordinator", "127.0.0.1:1"]
    for shards in ("2", "auto"):
        capsys.readouterr()
        assert cli.main(coord + ["--num-processes", "2", "--process-id", "0",
                                 "--sa-shards", shards] + files
                        + [str(tmp_path / "a")]) == 1
        err = capsys.readouterr().err.splitlines()
        assert len(err) == 1 and err[0].startswith("error: ") \
            and "item 10b" in err[0]
    assert cli.main(coord + ["--num-processes", "2"] + files
                    + [str(tmp_path / "b")]) == 1
    assert "--process-id" in capsys.readouterr().err
    with pytest.raises(ValueError, match="--process-id"):
        multihost.initialize("127.0.0.1:1", 2, None)
    assert multihost.initialize(None) is False
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    for shards in (2, "auto"):
        with pytest.raises(ValueError, match="item 10b"):
            multihost.run_multihost(*_inputs(toy_fixture),
                                    str(tmp_path / "g"),
                                    ExtractorConfig(precompute_count=30),
                                    sa_shards=shards, device="cpu")
    assert not any((tmp_path / d).exists() for d in ("a", "b", "g"))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _bootstrap_failed(errs) -> bool:
    """A failure of the process group's bootstrap (the only one retried: a
    crash must surface)."""
    markers = (b"DistNetworkError", b"Connection refused", b"timed out",
               b"Address already in use", b"EADDRINUSE")
    return any(m in e for e in errs for m in markers)


def _run_two(tmp_path, files, extra, attempts=2, env0=None):
    """The port's CLI as processes 0 and 1 of one group, sharing an index
    dir (``env0``: process 0's extra environment) -> (return codes, stderr
    texts, output dir, timefile, each process's seconds)."""
    env = dict(os.environ)
    env["GLOO_SOCKET_IFNAME"] = "lo"
    envs = [{**env, **(env0 or {})}, env]
    for attempt in range(attempts):
        out = tmp_path / f"out{attempt}"
        idx = tmp_path / f"idx{attempt}"
        tf = tmp_path / f"times{attempt}"
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "cgx_tpu_torch.cli", "--device", "cpu",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(pid), "--index-dir", str(idx), "-s",
             str(tf), *extra, *files, str(out)],
            cwd=str(REPO), env=envs[pid], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for pid in range(2)]
        t0 = time.monotonic()
        try:
            errs, secs = [], []
            for p in procs:
                errs.append(p.communicate(timeout=300)[1])
                secs.append(time.monotonic() - t0)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rcs = [p.returncode for p in procs]
        if rcs == [0, 0] or attempt + 1 == attempts \
                or not _bootstrap_failed(errs):
            return rcs, [e.decode() for e in errs], out, tf, secs
        shutil.rmtree(out, ignore_errors=True)


@pytest.mark.parametrize("extra", [[], ["--dp-devices", "2"]],
                         ids=["one_device", "dp2"])
def test_two_processes_equal_one(toy_fixture, tmp_path, extra):
    """Two gloo processes of the CLI: process 0 builds and saves the index,
    process 1 waits for its word and loads; each writes its contiguous
    slice; the files equal, byte for byte, those of the JAX CLI with the
    same flags and those of a one-process run of the port."""
    F = toy_fixture
    files = [str(F / n) for n in ("corpus.f", "query.f", "corpus.e",
                                  "corpus.a", "lex.txt")]
    one, jax_out = tmp_path / "one", tmp_path / "jax"
    assert cli.main(["--device", "cpu"] + files + [str(one)]) == 0
    assert jcli.main(extra + files + [str(jax_out)]) == 0
    rcs, errs, out, tf, _ = _run_two(tmp_path, files, extra)
    assert rcs == [0, 0], errs
    ref = sorted(p.name for p in one.iterdir())
    assert len(ref) == 8
    for other in (out, jax_out):
        assert sorted(p.name for p in other.iterdir()) == ref
        for name in ref:
            assert (one / name).read_bytes() == \
                (other / name).read_bytes(), (other, name)
    total = sum(len((one / n).read_text().splitlines()) for n in ref)
    for pid, (lo, hi) in enumerate([(0, 4), (4, 8)]):
        assert (f"multihost: process {pid}: queries [{lo}, {hi}) done; "
                f"{total} grammar lines globally") in errs[pid]
    lines = tf.read_text().splitlines()
    assert len(lines) == 2
    assert all(" | global max-across-processes: " in ln for ln in lines)
    # process 0 built (and saved) the index; process 1 loaded it
    assert all("indexsave" in ln.split(" | ")[1] for ln in lines)
    assert sum("indexload" in ln.split(" | ")[0] for ln in lines) == 1


def test_failed_build_fails_the_peer_at_once(toy_fixture, tmp_path):
    """Process 0's build fails (its budget cannot hold the toy): it ends in
    one error line, and process 1, waiting for its word, fails at once
    rather than at the group's timeout; no grammar is written."""
    F = toy_fixture
    files = [str(F / n) for n in ("corpus.f", "query.f", "corpus.e",
                                  "corpus.a", "lex.txt")]
    rcs, errs, out, _, secs = _run_two(tmp_path, files, [],
                                       env0={"CGX_DEVICE_MEM_MB": "0.05"})
    assert rcs[0] == 1 and rcs[1] != 0, errs
    assert [ln for ln in errs[0].splitlines() if ln.startswith("error: ")] \
        and "item 10b" in errs[0]
    assert "process 0 did not build the index" in errs[1]
    assert max(secs) < multihost.TIMEOUT_S / 4
    assert not out.exists() or not any(out.iterdir())
