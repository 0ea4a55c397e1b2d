"""The readings the limits of a cell's check are set from, at the cell's own
size on the card, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 4,5,6] [--seconds 2]

For each seed of ``--seeds`` it runs the cell as a run does (set-up, a
short window, the check) and prints the program's numbers: their largest
over the seeds is a limit's lower reading.  For each seed of
``--control-seeds`` it prints the numbers of the control, the reference
put in the program's place at the precision below the configuration's
(``fp8`` for bf16 products, ``bfloat16`` for float32 state), and of each
fault a training cell can have, planted in the reference put in the
program's place (``half_batch``: each minibatch's gradient and metrics
over half its samples; a state left unchanged reads 1 on ``change_gap``
by construction and needs no run).  The benchmark's own runs never run
this.

    python3 benchmark/calibrate.py --workload <cell> --set-limits limits/<cell>.readings.jsonl

writes ``limits/<cell>.json`` from such readings (a run's ``checked``
numbers may join them as ``program`` rows): for each number its lower
reading (the largest over the program's seeds) and its upper one (the
smallest of the control's, where it reads three times the lower or more,
and, in a training cell, of each fault that reads ten times the lower or
more; a state left unchanged reads 1 on ``change_gap``, where that is
three times the lower).  The limit lies between them at
``lower^0.4 upper^0.6``, past their geometric mean, since fresh seeds read
higher than the ones a limit was set from, and at most ten times the
lower reading, so that a fault the control does not stand for still
shows.  A number with no upper reading gets no limit and is left out of
the check, its readings kept in the file.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

CONTROLS = {"bfloat16": "fp8", "float32": "bfloat16"}  # the precision below the configuration's
TRAIN_FAULTS = ("half_batch",)  # the faults planted in the reference put in a training cell's program place


def set_limits(rows: list, kind: str) -> dict:
    """The limits file of a cell from its calibration ``rows`` (module
    docstring)."""
    program = [r["numbers"] for r in rows if r["what"] == "program"]
    controls = [r["numbers"] for r in rows if r["what"].startswith("control_")]
    faults = {}
    for r in rows:
        if r["what"].startswith("fault_"):
            faults.setdefault(r["what"], []).append(r["numbers"])
    numbers, dropped = {}, {}
    for name in program[0]:
        lower = max(p[name] for p in program)
        readings = {"control": (min(c[name] for c in controls), 3)}
        if kind == "train":
            readings.update({what: (min(f[name] for f in got), 10) for what, got in faults.items()})
            if name == "change_gap":  # a state left unchanged reads 1
                readings["fault_frozen"] = (1.0, 3)
        qualified = {what: v for what, (v, times) in readings.items() if v >= times * lower and v > 0}
        entry = {"lower": lower, "readings": {what: v for what, (v, _) in readings.items()},
                 "program_seeds": len(program), "control_seeds": len(controls)}
        if not qualified:
            dropped[name] = entry
            continue
        upper_from = min(qualified, key=qualified.get)
        upper = qualified[upper_from]
        limit = float(f"{min(lower ** 0.4 * upper ** 0.6, 10 * lower):.2g}")
        numbers[name] = dict(limit=limit, upper=upper, upper_from=upper_from, **entry)
    return {"numbers": numbers, "not_compared": dropped}


def main() -> int:
    import argparse

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    from benchmark import harness, loops

    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--set-limits", default="")
    args = parser.parse_args()
    if args.set_limits:
        rows = [json.loads(line) for line in open(args.set_limits) if line.strip()]
        man = harness.manifest()
        traffic = harness.load_json(harness.HERE / "traffic" / f"{harness.cell_of(man, args.workload)['traffic']}.json")
        out = set_limits([r for r in rows if r["workload"] == args.workload], traffic["loop"])
        (harness.HERE / "limits" / f"{args.workload}.json").write_text(json.dumps(out, indent=1) + "\n")
        print(json.dumps(out, indent=1))
        return 0
    if not torch.cuda.is_available():
        print("calibration runs on the card", file=sys.stderr)
        return 3
    man = harness.manifest()
    cell = harness.cell_of(man, args.workload)
    config = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    kind = traffic["loop"]

    def one(seed: int, controls: bool) -> None:
        t0 = time.perf_counter()
        loop = loops.loop_class(kind)(config, traffic, seed, "cuda:0")
        loop.setup()
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < args.seconds:
            loop.call()
        loop.free()
        rows, details = {}, {}
        if controls:
            what = "control_" + CONTROLS[loop.precision]
            rows[what] = loop.check(rounding=CONTROLS[loop.precision])
            details[what] = getattr(loop, "details", None)
            for fault in TRAIN_FAULTS if kind == "train" else ():
                rows["fault_" + fault] = loop.check(fault=fault)
                details["fault_" + fault] = getattr(loop, "details", None)
        else:
            rows["program"] = loop.check()
            details["program"] = getattr(loop, "details", None)
        for what, numbers in rows.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "what": what, "numbers": numbers,
                              "details": details.get(what), "seconds": time.perf_counter() - t0}), flush=True)
        del loop
        torch.cuda.empty_cache()

    for s in filter(None, args.seeds.split(",")):
        one(int(s), False)
    for s in filter(None, args.control_seeds.split(",")):
        one(int(s), True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
