"""ShapeNet part-segmentation dataset.

Counterpart of ``crfconv_tpu/data/datasets/shapenet.py``.

Reference: datasets/shapenet_dataset.py:9-117.  Raw layout: per-category
directories of per-shape txt files (xyz, normal, part label per row) plus
``synsetoffset2category.txt`` and the official ``train_test_split`` json
lists.  process() converts each split to one .npz of concatenated shapes
with slice offsets; train = train+val (as the reference collates),
test = test.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from crfconv_tpu_torch.data.datasets.base import ProcessedDataset, fixed_size_choice


class ShapeNetNormalDataset(ProcessedDataset):
    def __init__(
        self,
        root: str,
        train: bool = True,
        num_points: int = 2048,
        categories: Optional[List[str]] = None,
    ):
        self.category_ids: Dict[str, str] = {}
        self.obj_classes: Dict[str, int] = {}
        with open(
            os.path.join(root, "raw", "synsetoffset2category.txt")
        ) as f:
            for i, line in enumerate(f):
                name, synset = line.strip().split("\t")
                self.category_ids[name] = synset
                self.obj_classes[name] = i
        self.categories = categories or list(self.category_ids)
        self.num_points = num_points
        super().__init__(root)

        path = os.path.join(
            self.processed_dir, "training.npz" if train else "testing.npz"
        )
        blob = np.load(path)
        self._pos = blob["pos"]
        self._norm = blob["norm"]
        self._y = blob["y"]
        self._category = blob["category"]
        self._offsets = blob["offsets"]  # [num_shapes + 1]

    # ------------------------------------------------------------------
    def _file_lists(self):
        lists = []
        for split in ("train", "val", "test"):
            p = os.path.join(
                self.raw_dir, "train_test_split",
                f"shuffled_{split}_file_list.json",
            )
            with open(p) as f:
                entries = json.load(f)
            lists.append(
                [
                    os.path.join(
                        self.raw_dir, e.split("/")[1], e.split("/")[2] + ".txt"
                    )
                    for e in entries
                ]
            )
        return lists

    def _collect(self, file_list):
        synset_to_class = {
            v: self.obj_classes[k] for k, v in self.category_ids.items()
        }
        pos, norm, y, cat, offsets = [], [], [], [], [0]
        for filename in file_list:
            synset = os.path.basename(os.path.dirname(filename))
            raw = np.loadtxt(filename, dtype=np.float32)
            raw = np.atleast_2d(raw)
            pos.append(raw[:, 0:3])
            norm.append(raw[:, 3:6])
            y.append(raw[:, -1].astype(np.int32))
            cat.append(synset_to_class[synset])
            offsets.append(offsets[-1] + raw.shape[0])
        return {
            "pos": np.concatenate(pos).astype(np.float32),
            "norm": np.concatenate(norm).astype(np.float32),
            "y": np.concatenate(y),
            "category": np.asarray(cat, np.int32),
            "offsets": np.asarray(offsets, np.int64),
        }

    def process(self):
        train_list, val_list, test_list = self._file_lists()
        np.savez_compressed(
            os.path.join(self.processed_dir, "training.npz"),
            **self._collect(train_list + val_list),
        )
        np.savez_compressed(
            os.path.join(self.processed_dir, "testing.npz"),
            **self._collect(test_list),
        )

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self._category.shape[0]

    def get_sample(self, rng: np.random.Generator, idx: Optional[int] = None):
        """One shape, padded/cropped to num_points.

        x = [pos, normals] (reference models/point_conv.py:513).
        """
        if idx is None:
            idx = int(rng.integers(len(self)))
        lo, hi = self._offsets[idx], self._offsets[idx + 1]
        sel = fixed_size_choice(hi - lo, self.num_points, rng) + lo
        pos = self._pos[sel]
        return {
            "pos": pos,
            "x": np.concatenate([pos, self._norm[sel]], axis=-1),
            "y": self._y[sel].astype(np.int64),
            "category": np.int64(self._category[idx]),
            "point_idx": (sel - lo).astype(np.int64),
            "cloud_idx": np.int64(idx),
        }
