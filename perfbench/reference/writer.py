"""Grammar lines in the cdec rule format (PrintResults.c:339-577): per query,
the blocks' abX, Xab, XabX and ab rules, then each distinct one-gap
pattern's aXb, XaXb and aXbX, then each two-gap pattern's aXbXc; features
printed with C's "%f"."""

from __future__ import annotations

_FMT = ("[X] ||| %s ||| EgivenFCoherent=%f SampleCountF=%f CountEF=%f "
        "MaxLexFgivenE=%f MaxLexEgivenF=%f IsSingletonF=%d IsSingletonFE=%d")


def format_lines(rules) -> list:
    """One line per ``FastSpeed`` rule, in order."""
    return [_FMT % (r.lexical, float(r.aa), float(r.fsample_score),
                    float(r.bb), float(r.max_lex_fge), float(r.max_lex_egf),
                    int(r.f == 1), int(r.paircount == 1)) for r in rules]


def _emit(lines, updown, fmt, rid: int):
    d, u = updown[rid]
    if d == -1 or u == -1:
        return
    lines.extend(fmt[d:u + 1])


def grammar_lines_for_query(q: int, qry_global, one_q_ids, two_q_ids,
                            ud_contig, ud_one, ud_two,
                            fmt_contig, fmt_one, fmt_two,
                            G: int, D1: int, D2: int):
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
