"""Seeded indoor rooms: the benchmark's input generator.

A frozen copy of the room generator of ``crfconv_tpu_torch/parity/
synthetic.py`` (``_make_room`` and its helpers, numpy only), so that a
later change to the program cannot change the benchmark's inputs. A room
is floor, ceiling and walls with beams, columns, windows, a door, a board,
tables, chairs, bookcases, a sofa and clutter, each part sampled on its
surface with S3DIS's 13 class names and a noisy colour per class.

:func:`make_clouds` draws a set of such rooms at a fixed number of points
each, in random point order, as the arrays the traffic mixes feed.
"""

from __future__ import annotations

import numpy as np

CLASSES = ("ceiling", "floor", "wall", "beam", "column", "window", "door",
           "table", "chair", "sofa", "bookcase", "board", "clutter")

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



def make_cloud(rng, n: int):
    """One room of exactly ``n`` points in random order: (xyz [n, 3],
    rgb [n, 3] in 0..255, class id [n] into CLASSES), float64/int64."""
    xyz, rgb, cls = [], [], []
    for name, pts in _make_room(rng, n):
        base = np.asarray(_BASE_RGB[name], np.float64)
        xyz.append(pts)
        rgb.append(np.clip(base[None, :] + rng.normal(0, 22, pts.shape),
                           0, 255))
        cls.append(np.full(pts.shape[0], CLASSES.index(name), np.int64))
    perm = rng.permutation(n)
    return (np.concatenate(xyz)[perm], np.concatenate(rgb)[perm],
            np.concatenate(cls)[perm])


def make_clouds(seed: int, count: int, n: int, in_channels: int,
                n_classes: int, label_offset: int,
                unlabeled_share: float = 0.03):
    """``count`` rooms of ``n`` points from ``seed``: positions [count, n,
    3] float32, features [count, n, in_channels] float32 (colour / 255,
    then the positions less their mean, then zeros) and labels [count, n]
    int64. A room's class c is label ``label_offset + c % n_classes``; a
    share ``unlabeled_share`` of the points, drawn from the seed, gets the
    unlabeled label ``label_offset - 1`` instead."""
    rng = np.random.default_rng(seed)
    pos = np.empty((count, n, 3), np.float32)
    feats = np.zeros((count, n, in_channels), np.float32)
    labels = np.empty((count, n), np.int64)
    for i in range(count):
        xyz, rgb, cls = make_cloud(rng, n)
        pos[i] = xyz
        cols = np.concatenate([rgb / 255.0, xyz - xyz.mean(0)], axis=1)
        feats[i, :, :min(6, in_channels)] = cols[:, :in_channels]
        y = label_offset + cls % n_classes
        y[rng.random(n) < unlabeled_share] = label_offset - 1
        labels[i] = y
    return pos, feats, labels
