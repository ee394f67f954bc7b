"""Readings that set a cell's limits: the program's and the control's.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 2

For each seed, in one process: the cell's set-up, a short window at the
cell's own sizes and load, then the check twice, once of what the
program produced and once of the control, the plain reference put in the
program's place and computed at the precision below the configuration's
(each driver's ``check(control=True)``).  Prints one JSON line per seed
with both readings; the limits in ``workloads/<cell>.json`` lie between
the program's largest and the control's smallest.  Needs a CUDA device.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import run as _run
from faults import FAULTS


def main(argv=None) -> int:
    _run._environment()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--fault", choices=FAULTS,
                   help="plant this fault under the harness (faults.py) and "
                        "read the program's numbers with it")
    args = p.parse_args(argv)

    import torch

    from portbench import core, faults

    spec = core.cell_spec(core.benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        kind = spec["traffic"]["kind"]
        with (faults.plant(kind, args.fault) if args.fault else contextlib.nullcontext()):
            cell = core.driver(kind).Cell(spec, seed, dev)
            win = core.run_window(cell.enqueue, args.seconds, torch, True)
            cell.close_window()
            cell.release()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        prog = {c["name"]: c["value"] for c in cell.check()}
        t2 = time.perf_counter()
        out = {"seed": seed, "fault": args.fault, "units": win["units"], "program": prog,
               "check_s": t2 - t1, "run_s": t1 - t0}
        if not args.no_control:
            out["control"] = {c["name"]: c["value"] for c in cell.check(control=True)}
        print(json.dumps(out), flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
