"""The least time a call could take on the card, the larger of its
integer multiplies over the multiply pipe's peak and its bytes over the
memory's (``floors/``, from the cell's shapes), over the call's device
time: the device busy time of the traced stretch over its calls, whatever
kernels did the work."""


def read(rec):
    tr, fl, pk = rec["trace"], rec["floor"], rec["peaks"]
    if not tr or not fl or not pk or tr["busy_s"] <= 0:
        return None
    terms = [fl[k] / pk[p] for k, p in (("int_mul", "int_mul"), ("bytes", "hbm_bytes"))
             if k in fl]
    if not terms:
        return None
    least = max(terms)
    return 100.0 * least / (tr["busy_s"] / tr["units"])
