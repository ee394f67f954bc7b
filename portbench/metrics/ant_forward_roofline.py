"""The ant's forwards against their floor: the least time the card could
take for the traced updates' forwards (the larger of their FLOPs over the
f32 peak and their bytes over the memory's, ``floors/``) over the device
time the trace gives the ant kernels (``ant_smooth``, ``ant_rows``,
``ant_newton``).  Silent where the trace holds none of them."""

import re

KERNELS = re.compile(r"ant_(smooth|rows|newton)")


def read(rec):
    tr, fl, pk = rec["trace"], rec["floor"], rec["peaks"]
    if not tr or not fl or not pk:
        return None
    t = sum(s for name, s in tr["op_seconds"].items() if KERNELS.search(name))
    if t <= 0:
        return None
    fwd = fl["forward"]
    least = max(fwd["flops"] / pk["f32_flops"], fwd["bytes"] / pk["hbm_bytes"])
    return 100.0 * least * fl["forwards_per_update"] * tr["units"] / t
