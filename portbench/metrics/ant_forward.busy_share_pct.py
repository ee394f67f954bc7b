"""The share of the device's busy time in the traced stretch that the ant
kernels (``ant_smooth``, ``ant_rows``, ``ant_newton``) take; the rest is
the integrator's glue and the learn half.  Silent where the trace holds
none of them."""

import re

KERNELS = re.compile(r"ant_(smooth|rows|newton)")


def read(rec):
    tr = rec["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    t = sum(s for name, s in tr["op_seconds"].items() if KERNELS.search(name))
    return 100.0 * t / tr["busy_s"] if t > 0 else None
