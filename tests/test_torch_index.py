"""The port's TorchGrammarIndex holds exactly the JAX GrammarIndex's arrays
(same padding, same RLP bits, same seed tables)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.index import container as jic  # noqa: E402
from cgx_tpu.preproc import corpus as jcp  # noqa: E402
from cgx_tpu.preproc import suffix_array as jsab  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.preproc import corpus as tcp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as tsab  # noqa: E402


def _read(d):
    return (jcp.read_lines(str(d / "corpus.f")), jcp.read_lines(str(d / "corpus.e")),
            jcp.read_lines(str(d / "corpus.a")), jcp.read_tokens(str(d / "lex.txt")),
            jcp.read_lines(str(d / "query.f")))


def _jax_index(f, e, a, lex_t):
    src = jcp.load_source_corpus(f)
    tgt = jcp.load_target_corpus(e)
    al = jcp.load_alignment_fast(a, src, tgt)
    lex = jcp.load_lex_table(lex_t, src.vocab, tgt.vocab)
    sa = jsab.build_index(src.str_)
    return jic.build_index(src, tgt, sa, al, lex, JaxConfig())


def _torch_index(f, e, a, lex_t):
    src = tcp.load_source_corpus(f)
    tgt = tcp.load_target_corpus(e)
    al = tcp.load_alignment_fast(a, src, tgt)
    lex = tcp.load_lex_table(lex_t, src.vocab, tgt.vocab)
    sa = tsab.build_index(src.str_)
    return tic.build_index(src, tgt, sa, al, lex, ExtractorConfig(), "cpu")


def _assert_same(ti, gi):
    assert ti.reflen == gi.reflen
    for name in ("refstr_padded", "sa", "lr_tar", "tgt_str"):
        got = getattr(ti, name).numpy()
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, np.asarray(getattr(gi, name)),
                                      err_msg=name)
    # RLP words keep their uint32 bits in int32 storage
    np.testing.assert_array_equal(ti.rlp.numpy().view(np.uint32),
                                  np.asarray(gi.rlp))
    np.testing.assert_array_equal(ti.lex_key, gi.lex_key)
    np.testing.assert_array_equal(ti.lex_val1_host.view(np.int32),
                                  gi.lex_val1_host.view(np.int32))
    np.testing.assert_array_equal(ti.lex_val2_host.view(np.int32),
                                  gi.lex_val2_host.view(np.int32))
    # the interval-LCP tree stays on the host until the LCP passes ask
    for name in ("lcpleft", "lcpright"):
        got = getattr(ti, f"{name}_host")
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, np.asarray(getattr(gi, name)),
                                      err_msg=name)
    assert ti._lcp is None
    for t, name in zip(ti.lcp_tables(), ("lcpleft", "lcpright")):
        assert t.device == ti.device and t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(gi, name)))
    assert ti.lcp_tables()[0] is ti.lcp_tables()[0]
    for a, b in zip(ti.seed_host, gi.seed_host):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("corpus", ["toy", "real"])
def test_index_tensors_equal_grammar_index(corpus, request):
    f, e, a, lex_t, _ = _read(request.getfixturevalue(f"{corpus}_fixture"))
    _assert_same(_torch_index(f, e, a, lex_t), _jax_index(f, e, a, lex_t))


@pytest.mark.parametrize("corpus", ["toy", "real"])
def test_from_jax_arrays_carries_the_jax_index(corpus, request):
    f, e, a, lex_t, _ = _read(request.getfixturevalue(f"{corpus}_fixture"))
    gi = _jax_index(f, e, a, lex_t)
    arrays = {name: np.asarray(getattr(gi, name)) for name in tic.ARRAY_FIELDS}
    arrays["reflen"] = gi.reflen
    ti = tic.from_jax_arrays(arrays, "cpu")
    assert ti.device == torch.device("cpu")
    _assert_same(ti, gi)


def test_query_tokens_cached_per_query_set(toy_fixture):
    f, e, a, lex_t, q = _read(toy_fixture)
    ti = _torch_index(f, e, a, lex_t)
    src = tcp.load_source_corpus(f)
    qs = tcp.load_queries(q, src.vocab)
    t1 = ti.query_tokens(qs)
    assert ti.query_tokens(qs) is t1
    np.testing.assert_array_equal(t1.numpy(), qs.padded_tokens())
    qs2 = tcp.load_queries(q[:2], src.vocab)
    t2 = ti.query_tokens(qs2)
    np.testing.assert_array_equal(t2.numpy(), qs2.padded_tokens())
