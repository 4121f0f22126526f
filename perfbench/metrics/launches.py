"""launches: kernel launches in the window (kernels.build.LAUNCHES), per
unit of the mix."""


def read(rec):
    if not rec["per_count"] or not rec["launches"]:
        return None
    return rec["launches"] / rec["per_count"]
