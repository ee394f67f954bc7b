"""The share of the traced stretch in which no kernel, copy or set ran on
the device (torch.profiler's device activity, the union of its
intervals), leaving out the gaps in which the host was flushing or
requesting the profiler's own buffers: the profiler makes those."""


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    window = tr["window_s"] - tr["profiler_idle_s"]
    if window <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / window)
