"""Device operations (kernels, copies, sets) in the traced stretch over
the updates in it."""


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["units"]:
        return None
    return tr["ops"] / tr["units"]
