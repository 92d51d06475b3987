#!/usr/bin/env python3
"""How many vote passes cover chip_smoke.py's S3DIS val room.

    python3 tools/vote_coverage.py [passes] [batches] [batch_size]

Writes chip_smoke.py's three rooms (the seed phases 27 and 29 use) under a
temporary directory, reads them with the port's S3DISRoomDataset at grid
0.04 and 8192 points a crop, and draws from the val room's possibility
sampler as the Trainer's vote passes do (``batches`` batches of
``batch_size`` crops a pass); prints the sub-cloud's points and the
minimum possibility after each pass. ``labeled_vote_eval`` stops at the
first pass whose minimum exceeds -0.5 + vote_delta (S3DIS: 1.0). Runs on
the host (no GPU).
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from crfconv_tpu_torch.data.datasets import S3DISRoomDataset  # noqa: E402


def main(passes: int = 8, batches: int = 2, batch_size: int = 8) -> None:
    with tempfile.TemporaryDirectory(prefix="vote_coverage_") as root:
        chip_smoke.write_s3dis_rooms(
            root, np.random.default_rng(chip_smoke.SEED + 27))
        val = S3DISRoomDataset(root, grid_size=0.04,
                               num_points=chip_smoke.N).test_set
        print("val sub-cloud points", [int(p.shape[0])
                                       for p in val.input_points])
        rng = np.random.default_rng(chip_smoke.SEED + 1)
        for p in range(passes):
            for _ in range(batches * batch_size):
                val.get_sample(rng)
            print(f"pass {p}: min possibility "
                  f"{float(np.min(val.min_possibility)):.4f}", flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
