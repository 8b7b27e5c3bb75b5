"""The cross-card combine: the fenced ``combine`` spans' ms per published
version in the window on rank 0 (each version's int32 partials as uint32
words in int64, all-reduced over the world, then mod 2^32).  Layer:
``core/fl/hierarchy.py`` ``combine``.
"""


def read(ctx):
    if ctx["entry"] != "tier" or not ctx["cell"].versions:
        return None
    d = [s.dur_ns for s in ctx["spans"] if s.name == "combine"]
    return 1e-6 * sum(d) / ctx["cell"].versions if d else None
