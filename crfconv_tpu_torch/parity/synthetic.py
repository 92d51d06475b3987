"""Structured synthetic S3DIS-style corpus for the at-scale parity run.

Counterpart of ``crfconv_tpu/parity/synthetic.py``, numpy only: for the
same seed it writes the same files, byte for byte. The charter's claim
(the reference recipe's full-cloud mIoU on S3DIS Area 5 within ±0.3
points) needs a comparison trained to a plateau, and this corpus stands in
for S3DIS where the real data is not at hand. It is non-trivial in the
ways that matter for the comparison:

  * room geometry: floor, ceiling and wall planes, beams, columns,
    windows, doors, boards, tables, chairs, sofas, bookcases and clutter,
    so a label is a function of geometric context (height, planarity,
    adjacency), not of a position hash;
  * S3DIS's 13 class names with a realistic imbalance (structural
    classes dominate; sofas and boards are rare);
  * RGB correlated with the class but noisy and overlapping, so colour
    alone cannot solve it;
  * many rooms across two areas, over 1M raw points at the default
    scale, so the vote and projection pipeline runs at realistic depth.

The layout is the raw S3DIS tree the dataset reader consumes (reference
datasets/s3dis_dataset.py:100-171): per room
``Annotations/<class>_<i>.txt`` of ``x y z r g b`` rows, and
``Area_<n>_anno.txt`` listing the rooms.
"""

from __future__ import annotations

import os

import numpy as np

# per-class base colors (r, g, b in 0..255): visually plausible and
# deliberately overlapping between wall-like classes
_BASE_RGB = {
    "ceiling": (235, 233, 225),
    "floor": (160, 140, 110),
    "wall": (210, 205, 195),
    "beam": (200, 195, 185),
    "column": (205, 200, 190),
    "window": (150, 180, 210),
    "door": (130, 95, 60),
    "table": (150, 110, 70),
    "chair": (90, 90, 120),
    "sofa": (120, 60, 60),
    "bookcase": (110, 80, 50),
    "board": (245, 245, 245),
    "clutter": (128, 128, 128),
}


def _rect(rng, n, origin, ex, ey, jitter=0.01):
    """n points on the parallelogram origin + u·ex + v·ey, u,v ∈ [0,1]."""
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    pts = (
        np.asarray(origin)[None, :]
        + u * np.asarray(ex)[None, :]
        + v * np.asarray(ey)[None, :]
    )
    return pts + rng.normal(0.0, jitter, pts.shape)


def _box(rng, n, lo, hi, jitter=0.01):
    """n points on the surface of an axis-aligned box [lo, hi]."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    dims = hi - lo
    # face areas: (x faces, y faces, z faces)
    areas = np.array(
        [
            dims[1] * dims[2], dims[1] * dims[2],
            dims[0] * dims[2], dims[0] * dims[2],
            dims[0] * dims[1], dims[0] * dims[1],
        ]
    )
    face = rng.choice(6, size=n, p=areas / areas.sum())
    u = rng.random(n)
    v = rng.random(n)
    pts = np.empty((n, 3))
    axis = face // 2
    side = face % 2
    for a in range(3):
        o1, o2 = [i for i in range(3) if i != a]
        m = axis == a
        pts[m, a] = np.where(side[m] == 0, lo[a], hi[a])
        pts[m, o1] = lo[o1] + u[m] * dims[o1]
        pts[m, o2] = lo[o2] + v[m] * dims[o2]
    return pts + rng.normal(0.0, jitter, pts.shape)


def _make_room(rng, pts_per_room: int):
    """One room → list of (class_name, xyz[n,3]) parts."""
    w = 4.0 + 4.0 * rng.random()       # x extent
    d = 4.0 + 4.0 * rng.random()       # y extent
    h = 2.6 + 0.6 * rng.random()       # z extent
    parts = []  # (class, pts, weight) — weight ∝ surface area share

    def add(cls, maker, area):
        parts.append((cls, maker, float(area)))

    # structural surfaces
    add("floor", lambda n: _rect(rng, n, (0, 0, 0), (w, 0, 0), (0, d, 0)),
        w * d)
    add("ceiling", lambda n: _rect(rng, n, (0, 0, h), (w, 0, 0), (0, d, 0)),
        w * d)
    for origin, ex in (
        ((0, 0, 0), (w, 0, 0)),
        ((0, d, 0), (w, 0, 0)),
        ((0, 0, 0), (0, d, 0)),
        ((w, 0, 0), (0, d, 0)),
    ):
        add(
            "wall",
            lambda n, o=origin, e=ex: _rect(rng, n, o, e, (0, 0, h)),
            float(np.linalg.norm(ex)) * h,
        )

    # beams under the ceiling (sometimes)
    if rng.random() < 0.7:
        nb = rng.integers(1, 3)
        for i in range(nb):
            y0 = (i + 1) * d / (nb + 1)
            add(
                "beam",
                lambda n, y=y0: _box(
                    rng, n, (0, y - 0.12, h - 0.25), (w, y + 0.12, h)
                ),
                0.5 * w,
            )
    # columns in two corners (sometimes)
    if rng.random() < 0.5:
        for cx, cy in ((0.25, 0.25), (w - 0.25, d - 0.25)):
            add(
                "column",
                lambda n, x=cx, y=cy: _box(
                    rng, n, (x - 0.18, y - 0.18, 0), (x + 0.18, y + 0.18, h)
                ),
                0.7 * h,
            )

    # windows on one wall, door on another, board on a third
    nwin = rng.integers(1, 4)
    for i in range(nwin):
        x0 = 0.5 + (w - 2.0) * rng.random()
        add(
            "window",
            lambda n, x=x0: _rect(
                rng, n, (x, d - 0.02, 0.9), (1.2, 0, 0), (0, 0, 1.2)
            ),
            1.4,
        )
    x0 = 0.5 + (w - 1.8) * rng.random()
    add(
        "door",
        lambda n, x=x0: _rect(
            rng, n, (x, 0.02, 0.0), (0.95, 0, 0), (0, 0, 2.1)
        ),
        2.0,
    )
    if rng.random() < 0.6:
        y0 = 0.6 + (d - 2.4) * rng.random()
        add(
            "board",
            lambda n, y=y0: _rect(
                rng, n, (0.02, y, 1.0), (0, 1.8, 0), (0, 0, 1.1)
            ),
            1.0,
        )

    # furniture: tables with chairs, bookcases, sofa
    ntab = rng.integers(1, 4)
    for _ in range(ntab):
        tx = 0.8 + (w - 2.4) * rng.random()
        ty = 0.8 + (d - 2.4) * rng.random()
        add(
            "table",
            lambda n, x=tx, y=ty: _box(
                rng, n, (x, y, 0.68), (x + 1.4, y + 0.8, 0.74)
            ),
            1.3,
        )
        for dx, dy in ((-0.45, 0.2), (1.5, 0.3)):
            if rng.random() < 0.8:
                add(
                    "chair",
                    lambda n, x=tx + dx, y=ty + dy: _box(
                        rng, n, (x, y, 0.0), (x + 0.42, y + 0.42, 0.85)
                    ),
                    0.8,
                )
    if rng.random() < 0.8:
        bx = 0.05 + (w - 1.3) * rng.random()
        add(
            "bookcase",
            lambda n, x=bx: _box(
                rng, n, (x, d - 0.35, 0), (x + 1.2, d - 0.05, 1.9)
            ),
            2.2,
        )
    if rng.random() < 0.35:
        sx = 0.6 + (w - 2.6) * rng.random()
        add(
            "sofa",
            lambda n, x=sx: _box(
                rng, n, (x, 0.1, 0.0), (x + 1.9, 0.95, 0.8)
            ),
            1.6,
        )
    # clutter blobs on floor / tables
    nclut = rng.integers(3, 8)
    for _ in range(nclut):
        cx = 0.3 + (w - 0.6) * rng.random()
        cy = 0.3 + (d - 0.6) * rng.random()
        cz = 0.0 if rng.random() < 0.7 else 0.74
        s = 0.1 + 0.25 * rng.random()
        add(
            "clutter",
            lambda n, x=cx, y=cy, z=cz, r=s: _box(
                rng, n, (x, y, z), (x + r, y + r, z + 1.5 * r)
            ),
            0.5,
        )

    weights = np.array([p[2] for p in parts])
    counts = rng.multinomial(pts_per_room, weights / weights.sum())
    out = []
    for (cls, maker, _), n in zip(parts, counts):
        if n > 0:
            out.append((cls, maker(int(n))))
    return out


def make_synthetic_rooms(
    root: str,
    areas=(1, 5),
    rooms_per_area: int = 8,
    pts_per_room: int = 80_000,
    seed: int = 0,
) -> int:
    """Write the corpus under ``root/raw``; returns total raw points."""
    from crfconv_tpu_torch.data.datasets.s3dis import DATA_DIR

    rng = np.random.default_rng(seed)
    raw = os.path.join(root, "raw")
    data_dir = os.path.join(raw, DATA_DIR)
    total = 0
    for area in areas:
        rels = []
        for r in range(rooms_per_area):
            rel = f"Area_{area}/office_{r}/Annotations"
            anno = os.path.join(data_dir, rel)
            os.makedirs(anno, exist_ok=True)
            counter: dict = {}
            for cls, xyz in _make_room(rng, pts_per_room):
                base = np.asarray(_BASE_RGB[cls], np.float64)
                rgb = np.clip(
                    base[None, :] + rng.normal(0, 22, (xyz.shape[0], 3)),
                    0, 255,
                )
                k = counter.get(cls, 0) + 1
                counter[cls] = k
                rows = np.column_stack([xyz, rgb])
                np.savetxt(
                    os.path.join(anno, f"{cls}_{k}.txt"), rows, fmt="%.3f"
                )
                total += xyz.shape[0]
            rels.append(rel)
        with open(os.path.join(raw, f"Area_{area}_anno.txt"), "w") as f:
            f.write("\n".join(rels) + "\n")
    return total
