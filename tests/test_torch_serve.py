"""The port's serve loop (``cgx_tpu_torch/serve.py``) on the CPU: several
requests from one context, each byte-identical to a one-shot CLI run
(tests/test_cli.py:69-111 on the port), the ``err`` and ``warn`` replies
that keep the server going, and serving from a persisted index."""

import io
import pathlib

import pytest

torch = pytest.importorskip("torch")

from cgx_tpu_torch import cli, serve  # noqa: E402


def _files(d):
    d = pathlib.Path(d)
    return [str(d / n) for n in ("corpus.f", "corpus.e", "corpus.a",
                                 "lex.txt")]


def _one_shot(toy_fixture, out):
    d = pathlib.Path(toy_fixture)
    rc = cli.main(["--device", "cpu", str(d / "corpus.f"), str(d / "query.f"),
                   str(d / "corpus.e"), str(d / "corpus.a"),
                   str(d / "lex.txt"), str(out)])
    assert rc == 0
    return sorted(out.glob("grammar.*"), key=_by_query)


def _by_query(p):
    return int(p.name.split(".")[1])


def _small_queries(toy_fixture, tmp_path):
    q_all = pathlib.Path(toy_fixture) / "query.f"
    q_small = tmp_path / "q_small.f"
    q_small.write_text("\n".join(q_all.read_text().splitlines()[:3]) + "\n")
    return q_all, q_small


@pytest.mark.parametrize("use_prewarm", [None, "file", "auto"])
def test_serve_loop_byte_identical_across_requests(toy_fixture, tmp_path,
                                                   use_prewarm):
    """Three requests (all queries, the first 3, all again) from ONE
    context, each byte-identical to the one-shot run; prewarm disabled,
    from a file, and from the corpus's own sentences (the default)."""
    q_all, q_small = _small_queries(toy_fixture, tmp_path)
    req = io.StringIO(f"{q_all} {tmp_path / 's_all'}\n"
                      f"{q_small} {tmp_path / 's_small'}\n"
                      f"{q_all} {tmp_path / 's_again'}\n")
    out = io.StringIO()
    served = serve.serve_loop(*_files(toy_fixture), inp=req, out=out,
                              prewarm={"file": str(q_small), "auto": "auto",
                                       None: None}[use_prewarm],
                              device="cpu")
    assert served == 3
    replies = out.getvalue().splitlines()
    assert len(replies) == 4
    assert replies[0].startswith("ready ")
    assert all(r.startswith("ok ") for r in replies[1:])
    assert [r.split()[1] for r in replies[1:]] == ["8", "3", "8"]

    ref = _one_shot(toy_fixture, tmp_path / "one_shot")
    for served_dir in ("s_all", "s_again"):
        got = sorted((tmp_path / served_dir).glob("grammar.*"), key=_by_query)
        assert [p.read_bytes() for p in got] == [p.read_bytes() for p in ref]
    assert sum(len(p.read_text().splitlines()) for p in ref) == \
        int(replies[1].split()[2])
    small = sorted((tmp_path / "s_small").glob("grammar.*"), key=_by_query)
    assert [p.read_bytes() for p in small] == [p.read_bytes()
                                               for p in ref[:3]]


def test_serve_answers_err_and_keeps_serving(toy_fixture, tmp_path):
    """A malformed request line and a query file that cannot be read each
    answer ``err``; the requests after them are served."""
    q_all, _ = _small_queries(toy_fixture, tmp_path)
    req = io.StringIO("just-one-field\n"
                      "\n"
                      f"{tmp_path / 'missing.q'} {tmp_path / 'never'}\n"
                      f"{q_all} {tmp_path / 'after'}\n")
    out = io.StringIO()
    served = serve.serve_loop(*_files(toy_fixture), inp=req, out=out,
                              prewarm=None, device="cpu")
    assert served == 1
    replies = out.getvalue().splitlines()
    assert replies[0].startswith("ready ")
    assert replies[1].startswith("err bad request line")
    assert replies[2].startswith("err FileNotFoundError")
    assert replies[3].startswith("ok 8 ")
    assert not (tmp_path / "never").exists()
    ref = _one_shot(toy_fixture, tmp_path / "one_shot")
    got = sorted((tmp_path / "after").glob("grammar.*"), key=_by_query)
    assert [p.read_bytes() for p in got] == [p.read_bytes() for p in ref]


def test_failed_prewarm_warns_then_serves(toy_fixture, tmp_path):
    q_all, _ = _small_queries(toy_fixture, tmp_path)
    out = io.StringIO()
    served = serve.serve_loop(*_files(toy_fixture),
                              inp=io.StringIO(f"{q_all} {tmp_path / 'g'}\n"),
                              out=out, prewarm=str(tmp_path / "nope.q"),
                              device="cpu")
    assert served == 1
    replies = out.getvalue().splitlines()
    assert replies[0].startswith("warn prewarm failed FileNotFoundError")
    assert replies[1].startswith("ready ")
    assert replies[2].startswith("ok 8 ")


def test_serve_from_an_index_dir(toy_fixture, tmp_path, capsys, monkeypatch):
    """``main`` with --index-dir: the first server builds and saves the
    index, the second loads it; both answer as the one-shot run."""
    q_all, _ = _small_queries(toy_fixture, tmp_path)
    idx = tmp_path / "idx"
    ref = _one_shot(toy_fixture, tmp_path / "one_shot")
    for k in range(2):
        dest = tmp_path / f"g{k}"
        monkeypatch.setattr("sys.stdin", io.StringIO(f"{q_all} {dest}\n"))
        assert serve.main(["--device", "cpu", "--index-dir", str(idx),
                           "--no-prewarm", *_files(toy_fixture)]) == 0
        assert (idx / "meta.json").exists()
        got = sorted(dest.glob("grammar.*"), key=_by_query)
        assert [p.read_bytes() for p in got] == [p.read_bytes() for p in ref]
    replies = capsys.readouterr().out.splitlines()
    assert [r.split()[0] for r in replies] == ["ready", "ok", "ready", "ok"]


def test_serve_cuda_without_a_card_raises(toy_fixture, monkeypatch):
    """--device cuda (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_loop(*_files(toy_fixture), inp=io.StringIO(""),
                         out=io.StringIO())
