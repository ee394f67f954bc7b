"""Seconds from the process's start to the first timed unit: imports,
kernel libraries, the env, weights and inputs, the warm-up (host clock)."""


def read(rec):
    return rec["setup_s"]
