#!/usr/bin/env python3
"""The port's benchmark: device and file MB/s and exactness of x3_tpu_torch
on a CUDA card, printed as one JSON line, last (x3_tpu_torch/bench.py).

    python3 bench_torch.py                                    # on the card
    python3 bench_torch.py --device cpu --batch 16 --decode-batch 32 --reps 1 \\
        --e2e-reps 1 --block-len 4 --blocks-per-frame 8      # the plain versions, small

Exit code 1 when an exactness key is false."""

import sys

from x3_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
