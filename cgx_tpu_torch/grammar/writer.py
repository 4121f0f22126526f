"""Grammar-file writer: cdec rule format, per-query files.

Mirrors print_query_GPU_Gappy / printGapMode (PrintResults.c:339-577): for every query
the blocks print abX, Xab, XabX, ab per contiguous block id; then aXb, XaXb, aXbX per
distinct 1-gap pattern id; then aXbXc per distinct 2-gap pattern id.  Line format and
feature order are PrintResults.c:355-364 (printf "%f" = 6-decimal fixed).

Copy of ``cgx_tpu/grammar/writer.py``.  Each distinct rule is formatted ONCE
(``format_lines`` over a RuleTable's columns); per-query grammars are slice
concatenations of those pre-rendered lines, so a rule shared by many queries
costs one formatting pass, not one per emission.
"""

from __future__ import annotations

import os

_FMT = ("[X] ||| %s ||| EgivenFCoherent=%f SampleCountF=%f CountEF=%f "
        "MaxLexFgivenE=%f MaxLexEgivenF=%f IsSingletonF=%d IsSingletonFE=%d")


def _format_lines_py(table) -> list:
    return [
        _FMT % (lx, aa, fss, bb, fge, egf, int(f == 1), int(pc == 1))
        for lx, aa, fss, bb, fge, egf, f, pc in zip(
            table.lexical, table.aa.astype(float),
            table.fsample_score.astype(float), table.bb.astype(float),
            table.max_lex_fge.astype(float), table.max_lex_egf.astype(float),
            table.f, table.paircount)
    ]


def format_lines(table) -> list:
    """All rule lines of a RuleTable, in order (one formatting pass).

    The 7-feature suffix formats natively when the C++ library is available
    (`cgx_format_features` — snprintf "%f" is byte-identical to Python's
    float __mod__, both correctly rounded; equality test-enforced), cutting
    the per-line Python %-format cost at whole-test-set rule counts
    (PrintResults.c:355-364 analog)."""
    import numpy as np
    from cgx_tpu_torch.preproc.native_build import load_native
    n = len(table.lexical)
    lib = load_native() if n else None
    if lib is None:
        return _format_lines_py(table)
    import ctypes
    lexs = "".join(table.lexical)
    lexb = lexs.encode("utf-8")
    lex_offs = np.zeros(n + 1, np.int64)
    if len(lexb) == len(lexs):   # pure ASCII: char offsets == byte offsets
        np.cumsum(np.fromiter(map(len, table.lexical), np.int64, count=n),
                  out=lex_offs[1:])
    else:
        np.cumsum([len(s.encode("utf-8")) for s in table.lexical],
                  out=lex_offs[1:])
    cap = len(lexb) + 360 * n
    # np.empty, not ctypes.create_string_buffer: the latter zero-fills the
    # whole capacity (~0.3s at whole-test-set rule counts)
    buf = np.empty(cap, np.uint8)
    offs = np.empty(n + 1, np.int64)
    arrs = [np.ascontiguousarray(a, np.float32) for a in
            (table.aa, table.fsample_score, table.bb,
             table.max_lex_fge, table.max_lex_egf)]
    ints = [np.ascontiguousarray(a, np.int64)
            for a in (table.f, table.paircount)]
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    total = lib.cgx_format_rule_lines(
        lexb, lex_offs.ctypes.data_as(i64p),
        *(a.ctypes.data_as(f32p) for a in arrs),
        *(a.ctypes.data_as(i64p) for a in ints),
        n, buf.ctypes.data_as(ctypes.c_char_p), cap,
        offs.ctypes.data_as(i64p))
    if total < 0:   # pragma: no cover - 360B/row + lex bound never exceeded
        return _format_lines_py(table)
    raw = buf[:total].tobytes()
    o = offs.tolist()
    if len(lexb) == len(lexs):
        # pure ASCII: decode the buffer ONCE and slice the str (a str slice
        # is ~1.5x cheaper than a bytes slice + per-line decode)
        s = raw.decode("utf-8")
        return [s[o[i]:o[i + 1]] for i in range(n)]
    return [raw[o[i]:o[i + 1]].decode("utf-8") for i in range(n)]


def _emit(lines, updown, fmt, rid: int):
    d, u = updown[rid]
    if d == -1 or u == -1:
        return
    lines.extend(fmt[d:u + 1])


def grammar_lines_for_query(q: int, qry_global, one_q_ids, two_q_ids,
                            ud_contig, ud_one, ud_two,
                            fmt_contig, fmt_one, fmt_two,
                            G: int, D1: int, D2: int):
    """``fmt_*`` are the pre-rendered line lists from ``format_lines``."""
    lines: list = []
    for p in qry_global[q]:
        _emit(lines, ud_one, fmt_one, p + G)        # abX
        _emit(lines, ud_one, fmt_one, p)            # Xab
        _emit(lines, ud_two, fmt_two, p)            # XabX
        _emit(lines, ud_contig, fmt_contig, p)      # ab
    for s in one_q_ids[q]:
        _emit(lines, ud_one, fmt_one, 2 * G + s)            # aXb
        _emit(lines, ud_two, fmt_two, G + D2 + s)           # XaXb
        _emit(lines, ud_two, fmt_two, G + D2 + D1 + s)      # aXbX
    for s in two_q_ids[q]:
        _emit(lines, ud_two, fmt_two, G + s)                # aXbXc
    return lines


def write_grammars(dest_dir: str, qryscount: int, is_sample: bool, per_query_lines):
    os.makedirs(dest_dir, exist_ok=True)
    suffix = "s" if is_sample else "n"
    paths = []
    for q in range(qryscount):
        path = os.path.join(dest_dir, f"grammar.{q}.{suffix}")
        with open(path, "w", encoding="utf-8") as fh:
            fh.write("\n".join(per_query_lines[q]))
            if per_query_lines[q]:
                fh.write("\n")
        paths.append(path)
    return paths
