"""index_build_s: the window over the builds completed in it (whole builds
until the window is spent); a build that raised is not counted, and makes
the run not correct."""


def read(rec):
    if rec["kind"] != "build" or not rec["per_count"]:
        return None
    return rec["window_s"] / rec["per_count"]
