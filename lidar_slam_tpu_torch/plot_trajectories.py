"""Overlay saved trajectories (reference: plot_trajectories.py:1-15), the
port's counterpart of plot_trajectories.py:

    python -m lidar_slam_tpu_torch.plot_trajectories --poses a.npy b.npy

The same flags and defaults (--trajectory_files/--poses, --labels,
--figsize, --save_path/--out, --title). It reads .npy files and draws on
the host (utils/plotting.py: matplotlib, else a PNG rasterizer), so it
runs no tensor work on any device.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m lidar_slam_tpu_torch.plot_trajectories",
        description="Plot multiple trajectories")
    parser.add_argument("--trajectory_files", "--poses", dest="poses",
                        type=str, nargs="+", required=True,
                        help="Paths to .npy trajectory files")
    parser.add_argument("--labels", type=str, nargs="+", default=None,
                        help="Labels for each trajectory, optional")
    parser.add_argument("--figsize", type=int, nargs=2, default=[10, 10],
                        help="Figure size")
    parser.add_argument("--save_path", "--out", dest="out", type=str,
                        default="images/trajectory.png",
                        help="Path to save plot")
    parser.add_argument("--title", type=str, default="Trajectories",
                        help="Title for plot")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .utils import io
    from .utils.plotting import plot_trajectories

    poses = [io.load_numpy(p) for p in args.poses]
    plot_trajectories(poses, args.out, labels=args.labels, title=args.title,
                      figsize=tuple(args.figsize))
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
