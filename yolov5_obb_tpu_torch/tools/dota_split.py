"""Tile a DOTA dataset into training tiles (the reference
DOTA_devkit/ImgSplit_multi_process.py and prepare_dota1_ms.py).

    python -m yolov5_obb_tpu_torch.tools.dota_split --src /data/dota/train \\
        --dst /data/dotav1_split/train --subsize 1024 --gap 200   # one scale
    python -m yolov5_obb_tpu_torch.tools.dota_split ... --rates 0.5 1.0 1.5
    python -m yolov5_obb_tpu_torch.tools.dota_split ... --no-labels  # test set

The flags and printed lines of the JAX package's ``tools/dota_split.py``.
Reading, resizing and writing the images needs OpenCV.
"""

from __future__ import annotations

import argparse

from ..devkit.img_split import split_dataset


def parse_opt(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_obb_tpu_torch.tools.dota_split")
    p.add_argument("--src", required=True,
                   help="split dir containing images/ [+ labelTxt/]")
    p.add_argument("--dst", required=True)
    p.add_argument("--subsize", type=int, default=1024)
    p.add_argument("--gap", type=int, default=200)
    p.add_argument("--thresh", type=float, default=0.7)
    p.add_argument("--rates", type=float, nargs="+", default=[1.0])
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--ext", type=str, default=".png")
    p.add_argument("--no-labels", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse_opt(argv)
    total = 0
    for rate in a.rates:
        n = split_dataset(a.src, a.dst, rate=rate, subsize=a.subsize,
                          gap=a.gap, thresh=a.thresh, num_workers=a.workers,
                          ext=a.ext, with_labels=not a.no_labels)
        print(f"rate {rate}: {n} tiles")
        total += n
    print(f"done: {total} tiles → {a.dst}")
    return total


if __name__ == "__main__":
    main()
