"""Time some of the port's CUDA kernels on the card, as chip_smoke.py does.

    python3 scripts/time_kernels.py [--kernels splitter_ranks,...] [--seed 0]

For each named kernel (by default all six), at ``chip_smoke.py``'s timed
shape and on its seeded inputs: holds the kernel bit for bit against its
plain version, then prints one JSON line, the kernel's entry of
``chip_smoke.py``'s kernels line (one-call ``ms``, ``device_ms`` per
launch, the library call's, the bound) without the main path's launch
count; last the card's name and power limit.  Exits non-zero without
CUDA or when a kernel disagrees.

To compare two trees on one card: unpack the other (``git archive``)
into a git-ignored directory such as ``build/``, copy this script and
``chip_smoke.py`` into it, and run the two in one call in the order
A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", default="",
                        help="comma-separated kernel names (default: all)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 1
    table = chip_smoke.kernel_table()
    names = args.kernels.split(",") if args.kernels else [e[0] for e in table]
    unknown = set(names) - {e[0] for e in table}
    if unknown:
        parser.error(f"unknown kernels {sorted(unknown)}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for entry in table:
        if entry[0] in names:
            print(json.dumps(chip_smoke.kernel_row(*entry, gen, None)))
    print(chip_smoke.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
