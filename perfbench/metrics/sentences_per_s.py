"""sentences_per_s: query sentences whose grammars were written, over the
whole window (whole requests until the window is spent)."""


def read(rec):
    if rec["kind"] != "requests" or rec["per"] != "sentence":
        return None
    done = sum(r["sentences"] for r in rec["requests"] if r["ok"])
    return done / rec["window_s"]
