"""Qualitative reconstruction comparison figures.

Scriptable replacement for the reference's
``notebooks/reconstruction_visualisation.ipynb`` (C32): loads the
``target_* / output_{model}_* / zero_filled_*`` .npy volumes saved by the
inference runner and renders side-by-side x-y frames and x-t plane views
(the notebook's two qualitative checks). A copy of
``cinemri_tpu/cli/visualize.py``; matplotlib is imported inside
:func:`render_case`.

Usage:
    python -m cinemri_tpu_torch.cli.visualize --save_path results/ --out figs/
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List

import numpy as np

__all__ = ["collect_cases", "render_case", "main"]


def collect_cases(save_path: Path) -> Dict[str, Dict[str, Path]]:
    """Group artifact files by volume name: {vol: {kind: path}}."""
    cases: Dict[str, Dict[str, Path]] = {}
    for p in sorted(Path(save_path).glob("*.npy")):
        name = p.stem
        if name.startswith("target_"):
            kind, vol = "target", name[len("target_"):]
        elif name.startswith("zero_filled_"):
            kind, vol = "zero_filled", name[len("zero_filled_"):]
        elif name.startswith("output_"):
            rest = name[len("output_"):]
            model, vol = rest.split("_", 1)
            kind = f"output_{model}"
        else:
            continue
        cases.setdefault(vol, {})[kind] = p
    return cases


def render_case(vol: str, files: Dict[str, Path], out_dir: Path, frame: int = 0):
    """One figure per volume: rows = x-y frame view and x-t plane view,
    columns = target / zero-filled / each model output."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    order = ["target", "zero_filled"] + sorted(
        k for k in files if k.startswith("output_")
    )
    order = [k for k in order if k in files]
    vols = {k: np.load(files[k]) for k in order}
    t, h, w = vols[order[0]].shape

    fig, axes = plt.subplots(2, len(order), figsize=(3 * len(order), 6))
    if len(order) == 1:
        axes = axes[:, None]
    for j, k in enumerate(order):
        v = vols[k]
        vmax = np.percentile(vols["target"], 99.5) if "target" in vols else v.max()
        axes[0, j].imshow(v[frame], cmap="gray", vmin=0, vmax=vmax)
        axes[0, j].set_title(k.replace("output_", ""))
        # x-t plane through the image center (notebook cell 4 style)
        axes[1, j].imshow(v[:, :, w // 2].T, cmap="gray", vmin=0, vmax=vmax,
                          aspect=t / h * 4)
        for ax in (axes[0, j], axes[1, j]):
            ax.set_xticks([])
            ax.set_yticks([])
    axes[0, 0].set_ylabel("x-y")
    axes[1, 0].set_ylabel("x-t")
    fig.suptitle(vol)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"recon_{vol}.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def main(argv=None) -> List[Path]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save_path", type=Path, required=True,
                    help="directory with the inference .npy artifacts")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--frame", type=int, default=0)
    args = ap.parse_args(argv)
    out_dir = args.out or (args.save_path / "figures")
    written = []
    for vol, files in collect_cases(args.save_path).items():
        written.append(render_case(vol, files, out_dir, frame=args.frame))
    print(f"wrote {len(written)} figure(s) to {out_dir}")
    return written


if __name__ == "__main__":
    main()
