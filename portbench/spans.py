"""Reading the program's spans of a traced run (``Run.spans``: the
recorder of ``utils/profiling.py``, whose spans carry a name, an id, the
ids of their parent and root, ``start_ns``/``end_ns`` and attributes).

The harness puts each solve of a traced run under a root span ``SOLVE``
with the attributes ``window`` (False for the warm solve) and ``profiled``
(True where its Compute phase was profiled).  A *read* solve is a window
solve that was not profiled: host spans are read from those alone, so the
profiler's own cost stays out of them.  The arithmetic (a span's self
time, the outermost of nested spans) is kept here, so that the yardstick
does not move with the program.
"""

from __future__ import annotations

import collections

# the root span of each solve of a traced run
SOLVE = "portbench.solve"


def _roots(rec, *, window: bool, profiled: bool = False) -> list:
    return [s for s in rec.spans if s.name == SOLVE and s.attrs["window"] == window
            and s.attrs["profiled"] == profiled]


def _under(rec, roots) -> dict[int, list]:
    """The spans of each root, by the root's id."""
    ids = {r.id for r in roots}
    out = collections.defaultdict(list)
    for s in rec.spans:
        if s.root in ids and s.id != s.root:
            out[s.root].append(s)
    return out


def read_spans(run, name: str) -> tuple[int, list]:
    """(the run's read solves, the spans named ``name`` in them); (0, [])
    without a recording or a read solve."""
    if run.spans is None:
        return 0, []
    roots = _roots(run.spans, window=True)
    return len(roots), [s for r, kids in _under(run.spans, roots).items()
                        for s in kids if s.name == name]


def per_read_solve(run, name: str, value=lambda rec, s: s.seconds) -> float | None:
    """The mean over the read solves of ``value(recorder, span)`` summed
    over their spans named ``name``; None where there is no read solve or
    no such span."""
    n, found = read_spans(run, name)
    if not n or not found:
        return None
    return sum(value(run.spans, s) for s in found) / n


def _descendants(rec, span):
    """The spans inside ``span``: spans nest on the thread that opens them,
    so they are the ones that follow it in the recorder until one starts
    after its end."""
    for s in rec.spans[span.id + 1:]:
        if s.start_ns >= span.end_ns:
            return
        yield s


def self_seconds(rec, span) -> float:
    """``span``'s length less the part of it its children cover."""
    kids = sorted((max(c.start_ns, span.start_ns), min(c.end_ns, span.end_ns))
                  for c in _descendants(rec, span) if c.parent == span.id)
    covered, end = 0, span.start_ns
    for a, b in kids:
        if b > end:
            covered += b - max(a, end)
            end = b
    return (span.end_ns - span.start_ns - covered) * 1e-9


def warm_outermost(run, names) -> list:
    """The spans named one of ``names`` in the warm solve that no other of
    them encloses."""
    if run.spans is None:
        return []
    among = [s for kids in _under(run.spans, _roots(run.spans, window=False)).values()
             for s in kids if s.name in names]
    ids = {s.id for s in among}
    return [s for s in among if not _ancestor_in(run.spans, s, ids)]


def _ancestor_in(rec, span, ids) -> bool:
    parent = span.parent
    while parent is not None:
        if parent in ids:
            return True
        parent = rec.spans[parent].parent
    return False
