"""Shared arithmetic of the readers of the program's child phases and
counters: a phase's time less its engine calls (the ``engine.*`` child
phases under it, which hold the host tables, upload, launch, wait and copy
of each device stage), and the program's counters over the window per
unit of the mix.  The program's timer carries its counters beside its
phases, as ``count:<name>`` (the growth of ``kernels.build.snapshot()``),
so each request's or build's ``phases`` holds what it counted.  Each
returns None where the program records no such span or counter."""

from perfbench.metrics import _phases as ph


def _is_engine(key: str) -> bool:
    """An engine call's key: its last part ``engine.<method>``, and no
    engine call around it."""
    parts = key.split("/")
    return (len(parts) > 1 and parts[-1].startswith("engine.")
            and not any(p.startswith("engine.") for p in parts[:-1]))


def engine_seconds(phases: dict, parent: str = None) -> float:
    """The engine calls under ``parent`` (under any phase with None)."""
    return sum(v for k, v in phases.items() if _is_engine(k)
               and (parent is None or k.startswith(parent + "/")))


def has_children(items, parent: str = None) -> bool:
    """Whether any request or build recorded a child phase of ``parent``
    (of any phase with None): a program without them records none."""
    return any("/" in k and (parent is None or k.startswith(parent + "/"))
               for it in items for k in it["phases"])


def host_seconds(items, parent: str) -> float:
    """``parent``'s time less its engine calls, over ``items``."""
    return sum(it["phases"].get(parent, 0.0)
               - engine_seconds(it["phases"], parent) for it in items)


def host_ms(rec, parent: str):
    """``parent`` less its engine calls, in ms per unit of the mix."""
    if rec["kind"] != "requests" or not has_children(rec["requests"],
                                                     parent):
        return None
    return ph.per_unit_ms(rec, host_seconds(rec["requests"], parent))


COUNT = "count:"


def _items(rec):
    return rec["requests"] if rec["kind"] == "requests" else rec["builds"]


def counter_names(rec, prefix: str) -> list:
    """The counters the window recorded whose names start with
    ``prefix``."""
    return sorted({k[len(COUNT):] for it in _items(rec) for k in it["phases"]
                   if k.startswith(COUNT + prefix)})


def counter(rec, *names):
    """The sum of the counters ``names`` over the window; None where the
    window recorded none of them (a program without them, or a CPU run,
    which counts no copy or sync)."""
    keys = [COUNT + n for n in names]
    got = [it["phases"][k] for it in _items(rec) for k in keys
           if k in it["phases"]]
    return sum(got) if got else None


def per_unit(rec, value):
    """``value`` per unit of the mix; None without a value or a unit."""
    if value is None or not rec["per_count"]:
        return None
    return value / rec["per_count"]
