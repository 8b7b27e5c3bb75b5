"""Pair streams the card sums a version: the system's counter
``prf_device_pairs`` (each launch of its pair-sum kernel adds the pairs it
sweeps: a recovering flush's edges with one endpoint present, once a chunk)
over every version the run has driven (set-up's, the window's and the
profile's).  The count is a function of the sizes and the traffic alone,
the same in every version, so the quotient is each version's count.  A
system without the counter, or whose sweeps ran on the host, reads
nothing."""


def read(ctx):
    from repro_torch.core import telemetry as tele
    if ctx["entry"] != "agg":
        return None
    series = [v for (n, _), v in tele.get_default().counters().items()
              if n == "prf_device_pairs"]
    versions = len(ctx["cell"].log)
    if not series or not versions:
        return None
    return sum(series) / versions
