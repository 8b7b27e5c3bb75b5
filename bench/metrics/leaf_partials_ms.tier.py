"""The leaf's flush: the fenced ``leaf_partials`` spans' ms per published
version in the window on rank 0 (its leaf's stored rows summed into the
int32 partial, and the masks' recovery where slots are absent).  Layer:
``core/fl/hierarchy.py`` ``build_sharded_masked_step``.
"""


def read(ctx):
    if ctx["entry"] != "tier" or not ctx["cell"].versions:
        return None
    d = [s.dur_ns for s in ctx["spans"] if s.name == "leaf_partials"]
    return 1e-6 * sum(d) / ctx["cell"].versions if d else None
