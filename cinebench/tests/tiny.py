"""CPU sizes of the benchmark's cells for its tests: every width cut, so
the port runs its plain backends in seconds."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_MODEL = {"num_cascades": 2, "chans": 4, "pools": 2, "sens_chans": 4, "sens_pools": 2,
              "cg_iters": 2}
TINY_SHAPE = {"frames": 6, "coils": 3, "height": 32, "width": 32}
TINY_TRAFFIC = {"center_lines": 6, "pool": 2, "warmup": 1, "traced_items": 2,
                "op_traced_items": 1}
CPU_INFO = {"platform": "cpu", "kind": "cpu", "count": 1, "peaks": (67e12, 3.35e12),
            "power_limit": "none"}


def tiny_cell(name: str):
    """The cell ``name`` of BENCHMARK.json at the CPU sizes, with its limits."""
    import torch

    from cinebench.harness import bench

    torch.set_num_threads(2)
    cell = bench.load_cell(name)
    model = cell.config["model"]
    model.update({k: v for k, v in TINY_MODEL.items() if k in model})
    cell.config.update(TINY_SHAPE)
    cell.traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in cell.traffic})
    return cell
