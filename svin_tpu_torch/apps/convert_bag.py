"""rosbag2 → EuRoC-layout dataset exporter.

Usage:
  python -m svin_tpu_torch.apps.convert_bag <bag_dir_or_db3> <out_dir> \\
      [cam_topics_csv] [imu_topic]

Writes ``cam{i}/data/*.png`` + ``cam{i}/data.csv`` and ``imu0/data.csv``
under ``out_dir`` and prints the message counts per stream.
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 2
    bag, out = argv[0], argv[1]
    cam_topics = argv[2].split(",") if len(argv) > 2 else ["/cam0/image_raw", "/cam1/image_raw"]
    imu_topic = argv[3] if len(argv) > 3 else "/imu"

    from ..pipeline.rosbag import convert_bag_to_euroc

    counts = convert_bag_to_euroc(bag, out, cam_topics, imu_topic)
    print(" ".join(f"{k}={v}" for k, v in sorted(counts.items())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
