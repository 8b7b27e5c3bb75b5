"""The whole round's share of the chip's peak, in %: the least time of the
rounds of the traced window (``work/counts.py`` ``round_work``: the model's
products, the deltas, sums and parameters moved once, the Threefry-20
draws) at the published peaks, over the window's time."""
from bench.work import counts


def read(ctx):
    if ctx["entry"] != "train":
        return None
    cell = ctx["cell"]
    return (100.0 * cell.rounds
            * counts.least_time(ctx["work"]["round"]) / ctx["window_s"])
