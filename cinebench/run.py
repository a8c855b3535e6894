"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 cinebench/run.py --workload varnet_xf.serve --seed 7 --seconds 30 --trace 0

From the root of a checkout. Fails, printing no result, without a CUDA card
(or with fewer than the cell asks for), without the program, or when JAX or
the JAX package was loaded by the time the window closed. The last line of
standard output is the result's JSON object; the last lines of standard
error are each compared number beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from cinebench.harness import env

    env.set_cache_dirs()
    env.one_cpu_thread()
    import torch

    from cinebench.harness import bench, check, flops

    torch.set_num_threads(1)

    cell = bench.load_cell(args.workload)
    chips = next(w["chips"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cinebench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    info = {"platform": "gpu", "kind": name, "count": chips, "peaks": flops.peaks(name),
            "power_limit": env.power_limit()}
    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START,
                            torch.device("cuda", 0), info)
    found = env.forbidden_modules()
    if found:
        print(f"cinebench: the process loaded {found}", file=sys.stderr)
        return 3
    lines = [{"name": k, **v} for k, v in result["compared"].items()]
    for line in check.format_lines(lines):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
