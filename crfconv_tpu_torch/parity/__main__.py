"""CLI of the S3DIS parity harness:

    python -m crfconv_tpu_torch.parity --root ... [--device cuda]

Counterpart of ``crfconv_tpu/parity/__main__.py``, with its flags and
``--device`` (default ``cuda``; ``cpu`` runs both arms on the host).
"""

from __future__ import annotations

import argparse
import json
import logging

from crfconv_tpu_torch.utils.logging import init_logger


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="crfconv_tpu_torch.parity",
        description="S3DIS Area-5 mIoU parity: the port's flagship against "
        "the torch reference oracle (BASELINE.json ±0.3)",
    )
    ap.add_argument("--root", required=True, help="S3DIS dataset root "
                    "(raw/Stanford3dDataset_v1.2_Aligned_Version inside)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--num-votes", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the full JSON report")
    ap.add_argument(
        "--dry-run", action="store_true",
        help="synthesize a tiny raw corpus under --root and run the whole "
        "harness end to end (minutes, not hours)",
    )
    ap.add_argument(
        "--corpus", default=None, choices=[None, "rooms"],
        help="'rooms': the structured synthetic corpus at scale "
        "(parity/synthetic.py) instead of real S3DIS data",
    )
    ap.add_argument("--rooms-per-area", type=int, default=8)
    ap.add_argument("--pts-per-room", type=int, default=80_000)
    ap.add_argument(
        "--patience", type=int, default=None,
        help="early-stop patience (epochs without val-mIoU improvement)",
    )
    ap.add_argument(
        "--scale-kw", default=None,
        help="JSON dict of cfg overrides, e.g. "
        '\'{"sample_num": 4096, "batch_size": 4}\'',
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device of both arms (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the command line ``argv``; returns the report (or, with one arm
    of ``CRFCONV_PARITY_ARM`` run and the other's file missing, that arm's
    result and the pending arm)."""
    args = parse(argv)
    init_logger(level=logging.INFO)

    from crfconv_tpu_torch.parity import run_parity

    return run_parity(
        args.root, epochs=args.epochs, num_votes=args.num_votes,
        seed=args.seed, dry_run=args.dry_run, out=args.out,
        corpus=args.corpus, rooms_per_area=args.rooms_per_area,
        pts_per_room=args.pts_per_room, patience=args.patience,
        scale_kw=json.loads(args.scale_kw) if args.scale_kw else None,
        device=args.device,
    )


if __name__ == "__main__":
    main()
