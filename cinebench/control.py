"""Readings that set the limits of ``correct``: the program and the control, seed by seed.

    python3 cinebench/control.py --workload cinenet_xf.serve --seeds 11 12 13 [--f64]

In one process on the card, for each seed, at the cell's own sizes, the
cell's traffic loop (``loops/<kind>.py``, ``readings``) takes the program's
readings as a run takes them and the control's, the reference put in the
program's place with TF32 convolutions and matmuls, each compared with the
reference in float32 as a run compares them; a training loop adds the fault
"state unchanged". Each is then judged against the cell's limits
(``limits/<cell>.json``) by the run's own judgement, ``check.judge``: the
program has to come out correct, the control and each fault not. With
``--f64`` the program and the float32 reference are also each compared with
the reference in float64, a witness of which side lies closer to the exact
result. One JSON line per seed, then one line that sums up; exits 1 when
the program came out not correct, or the control or a fault correct, on any
seed. The benchmark's runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the readings judged, and whether each has to come out correct
JUDGED = {"program": True, "control": False, "fault_state_unchanged": False}


def judged(out: dict, limits: dict) -> dict:
    """``{side: correct}`` for each judged side of one seed's readings."""
    from cinebench.harness import check

    return {side: check.judge(out[side], limits)[0] for side in JUDGED if side in out}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--f64", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from cinebench.harness import env

    env.set_cache_dirs()
    import torch

    from cinebench import reference
    from cinebench.harness import bench

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    reference.full_f32()
    cell = bench.load_cell(args.workload)
    loop = bench.loop(cell.traffic["kind"])
    device = torch.device("cuda", 0)
    wrong = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = loop.readings(cell, seed, device, args.f64)
        verdicts = judged(out, cell.limits)
        wrong += [f"{side} seed {seed}" for side, ok in verdicts.items() if ok != JUDGED[side]]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": verdicts, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds), "limits": cell.limits,
                      "as_expected": not wrong, "unexpected": wrong}), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
