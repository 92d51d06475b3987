"""The port's host data layer against the JAX package's, on the CPU: PLY
I/O (binary and ascii, each package reading the other's files), every
transform, the possibility sampler, the block helpers and the six
datasets' readers on the same synthetic raw files, processed apart; and
the rule that the readers need neither pandas nor PyYAML."""

from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from crfconv_tpu.data import ply as jply
from crfconv_tpu.data import sampler as jsampler
from crfconv_tpu.data import transforms as jT
from crfconv_tpu.data.datasets import base as jbase
from crfconv_tpu_torch.data import ply, sampler
from crfconv_tpu_torch.data import transforms as T
from crfconv_tpu_torch.data.datasets import base
from tests.test_torch_ops import few_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# synthetic raw layouts (the JAX package's tests write the same kinds)
# ---------------------------------------------------------------------------


def write_s3dis(root, rng, n_pts=400, rooms=((1, 2), (5, 1))):
    """``Area_<a>`` with rooms of two classes, rows ``x y z r g b`` on a
    1e-3 grid as the dataset's files are; returns the root."""
    raw = os.path.join(root, "raw")
    data_dir = os.path.join(raw, "Stanford3dDataset_v1.2_Aligned_Version")
    for area, n_rooms in rooms:
        rels = []
        for r in range(n_rooms):
            rel = f"Area_{area}/office_{r}/Annotations"
            anno = os.path.join(data_dir, rel)
            os.makedirs(anno, exist_ok=True)
            for cls in ("wall_1", "floor_1", "stairs_1"):
                pts = np.column_stack([rng.random((n_pts, 3)) * 3,
                                       rng.integers(0, 255, (n_pts, 3))])
                np.savetxt(os.path.join(anno, cls + ".txt"), pts,
                           fmt="%.3f %.3f %.3f %d %d %d")
            rels.append(rel)
        with open(os.path.join(raw, f"Area_{area}_anno.txt"), "w") as f:
            f.write("\n".join(rels) + "\n")
    return root


def write_semantic3d(root, rng, n=4000):
    txt = os.path.join(root, "raw", "txt")
    os.makedirs(txt)
    for name, labeled in (("cloudA", True), ("cloudB", True),
                          ("cloudT", False)):
        pc = np.column_stack([rng.random((n, 3)) * 8, rng.random((n, 1)),
                              rng.integers(0, 255, (n, 3))])
        np.savetxt(os.path.join(txt, name + ".txt"), pc,
                   fmt="%.3f %.3f %.3f %d %d %d %d")
        if labeled:
            np.savetxt(os.path.join(txt, name + ".labels"),
                       rng.integers(0, 9, n), fmt="%d")
    return root


def write_scannet(root, rng):
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    rooms = [np.asarray(rng.random((3000, 3)) * 3, np.float32)
             for _ in range(2)]
    labels = [rng.integers(0, 21, 3000) for _ in range(2)]
    for name in ("scannet_train.pickle", "scannet_test.pickle"):
        with open(os.path.join(raw, name), "wb") as f:
            pickle.dump(rooms, f)
            pickle.dump(labels, f)
    return root


def write_npm3d(root, rng):
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    for name, n in (("lille1", 1500), ("lille2", 900)):
        jply.write_ply(
            os.path.join(raw, name + ".ply"),
            [(rng.random((n, 3)) * 12).astype(np.float32),
             (rng.random(n) * 255).astype(np.float32),
             rng.integers(0, 10, n).astype(np.int32)],
            ["x", "y", "z", "reflectance", "class"])
    with open(os.path.join(raw, "trainval.txt"), "w") as f:
        f.write("lille1\n")
    with open(os.path.join(raw, "test.txt"), "w") as f:
        f.write("lille2\n")
    return root


def write_kitti(root, rng):
    for seq, frames in (("00", 2), ("08", 1)):
        d = os.path.join(root, "raw", "sequences", seq)
        os.makedirs(os.path.join(d, "velodyne"))
        os.makedirs(os.path.join(d, "labels"))
        for i in range(frames):
            n = 900 + 50 * i
            rng.random((n, 4)).astype(np.float32).tofile(
                os.path.join(d, "velodyne", f"{i:06d}.bin"))
            sem = rng.choice([0, 10, 40, 48, 50, 252], n).astype(np.uint32)
            inst = rng.integers(0, 3, n).astype(np.uint32)
            (sem | (inst << 16)).tofile(
                os.path.join(d, "labels", f"{i:06d}.label"))
    return root


def write_shapenet(root, rng, shapes=4, points=(300, 340)):
    """The ShapeNet normal layout: every category of the dataset, its
    shapes' rows ``x y z nx ny nz part`` with parts in the category's own
    range, and the shuffled split lists."""
    from crfconv_tpu_torch.train.metrics import (
        SHAPENET_OBJ_CLASSES, SHAPENET_SEG_CLASSES,
    )

    raw = os.path.join(root, "raw")
    split_dir = os.path.join(raw, "train_test_split")
    os.makedirs(split_dir)
    names = sorted(SHAPENET_OBJ_CLASSES, key=SHAPENET_OBJ_CLASSES.get)
    with open(os.path.join(raw, "synsetoffset2category.txt"), "w") as f:
        for i, name in enumerate(names):
            f.write(f"{name}\t{i:08d}\n")
    entries = {"train": [], "val": [], "test": []}
    splits = ["train", "train", "val", "test"]
    for i, name in enumerate(names):
        synset = f"{i:08d}"
        os.makedirs(os.path.join(raw, synset))
        for j in range(shapes):
            n = int(rng.integers(*points))
            normal = rng.standard_normal((n, 3))
            normal /= np.linalg.norm(normal, axis=1, keepdims=True)
            pos = normal * rng.uniform(0.2, 0.8, 3)
            arr = np.column_stack([pos, normal,
                                   rng.choice(SHAPENET_SEG_CLASSES[name], n)])
            sid = f"shape{j:03d}"
            np.savetxt(os.path.join(raw, synset, sid + ".txt"), arr,
                       fmt="%.6f %.6f %.6f %.6f %.6f %.6f %d")
            entries[splits[j % len(splits)]].append(
                f"shape_data/{synset}/{sid}")
    for split, ent in entries.items():
        with open(os.path.join(
                split_dir, f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(ent, f)
    return root


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------


def _columns(rng, n=50):
    return ([rng.random((n, 3)).astype(np.float32),
             rng.integers(0, 256, (n, 3)).astype(np.uint8),
             rng.integers(-5, 13, n).astype(np.int32),
             rng.random(n)],     # float64, written as float
            ["x", "y", "z", "r", "g", "b", "class", "w"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ply_binary_both_ways(tmp_path, writer):
    cols, names = _columns(np.random.default_rng(1))
    faces = np.random.default_rng(2).integers(0, 50, (20, 3))
    f = str(tmp_path / "cloud.ply")
    (ply if writer == "port" else jply).write_ply(f, cols, names,
                                                  triangular_faces=faces)
    for reader in (ply, jply):
        verts, tri = reader.read_ply(f, triangular_mesh=True)
        np.testing.assert_array_equal(tri, faces)
        np.testing.assert_array_equal(
            np.stack([verts["x"], verts["y"], verts["z"]], 1), cols[0])
        assert verts["r"].dtype == np.uint8 and verts["w"].dtype == np.float32
        np.testing.assert_array_equal(verts["class"], cols[2])


def test_ply_bytes_match_jax(tmp_path):
    cols, names = _columns(np.random.default_rng(1))
    ply.write_ply(str(tmp_path / "port"), cols, names)
    jply.write_ply(str(tmp_path / "jax"), cols, names)
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()


def test_ply_ascii_and_big_endian(tmp_path):
    """An ascii file with ragged list rows and a big-endian binary file:
    both packages read the same arrays."""
    a = tmp_path / "ragged.ply"
    a.write_text(
        "ply\nformat ascii 1.0\ncomment made by hand\n"
        "element vertex 3\nproperty float x\nproperty uchar red\n"
        "element face 2\nproperty list uchar int vertex_indices\n"
        "end_header\n1.5 3\n2.5 4\n-0.125 255\n3 0 1 2\n4 2 1 0 2\n")
    b = tmp_path / "big.ply"
    rec = np.array([(1.25, 7), (-3.5, 9)], dtype=[("x", ">f4"), ("c", ">i4")])
    with open(b, "wb") as f:
        f.write(b"ply\nformat binary_big_endian 1.0\nelement vertex 2\n"
                b"property float x\nproperty int c\nend_header\n")
        rec.tofile(f)
    for path in (a, b):
        got = ply.read_ply_elements(str(path))
        ref = jply.read_ply_elements(str(path))
        assert got.keys() == ref.keys()
        for el in ref:
            assert got[el].keys() == ref[el].keys()
            for k in ref[el]:
                g, r = got[el][k], ref[el][k]
                assert g.dtype == r.dtype and g.shape == r.shape
                for gi, ri in zip(g, r):
                    np.testing.assert_array_equal(gi, ri)
    assert ply.read_ply(str(a))["red"].tolist() == [3, 4, 255]
    assert ply.read_ply(str(b))["c"].tolist() == [7, 9]


# ---------------------------------------------------------------------------
# transforms, sampler, block helpers
# ---------------------------------------------------------------------------

TRANSFORMS = {
    "rotate": lambda m: m.RandomRotate(180, axis=2),
    "rotate_x": lambda m: m.RandomRotate(30, axis=0),
    "scale": lambda m: m.RandomScaleAnisotropic((0.8, 1.2)),
    "symmetry": lambda m: m.RandomSymmetry((True, True, False)),
    "noise": lambda m: m.RandomNoise(0.001),
    "noise_unclipped": lambda m: m.RandomNoise(0.1, clip=None),
    "drop": lambda m: m.DropFeature(0.5, "rgb"),
    "feats": lambda m: m.AddFeatsByKeys(("pos", "rgb", "i")),
    "train": lambda m: m.default_train_transform(),
    "test": lambda m: m.default_test_transform(),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    rng = np.random.default_rng(3)
    sample = {"pos": rng.random((64, 3)).astype(np.float32),
              "rgb": rng.random((64, 3)).astype(np.float32),
              "i": rng.random(64).astype(np.float32),
              "y": rng.integers(0, 13, 64)}
    got_t, ref_t = TRANSFORMS[name](T), TRANSFORMS[name](jT)
    for seed in range(6):   # several draws: the random branches both ways
        got = got_t(sample, np.random.default_rng(seed))
        ref = ref_t(sample, np.random.default_rng(seed))
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("variant", ["s3dis", "weighted", "short"])
def test_sampler_matches_jax(variant):
    rng = np.random.default_rng(4)
    sizes = (300, 40) if variant == "short" else (500, 300)
    clouds = [rng.random((n, 3)).astype(np.float32) * 3 for n in sizes]
    labels = [rng.integers(0, 5, n) for n in sizes]
    kw = dict(labels=labels, seed=9, center_xy_only=variant != "s3dis")
    if variant == "weighted":
        kw["class_weight"] = rng.random(5)
    got = sampler.PossibilitySampler(clouds, 128, **kw)
    ref = jsampler.PossibilitySampler(clouds, 128, **kw)
    for i in range(12):
        a, b = got.sample(), ref.sample()
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")
        assert a["pos"].shape == (128, 3)
    sa, sb = got.state_dict(), ref.state_dict()
    assert sa["rng_state"] == sb["rng_state"]
    assert sa["min_possibility"] == sb["min_possibility"]
    for p, q in zip(sa["possibility"], sb["possibility"]):
        np.testing.assert_array_equal(p, q)
    # a resume replays the schedule
    after = [got.sample() for _ in range(3)]
    got.load_state_dict(sa)
    for a in after:
        np.testing.assert_array_equal(got.sample()["point_idx"],
                                      a["point_idx"])


def test_block_helpers_match_jax():
    rng = np.random.default_rng(5)
    xyz = (rng.random((3000, 3)) * [4, 3, 2]).astype(np.float32)
    got = list(base.split_blocks(xyz, 1.5, 1.0, 0.2, 50))
    ref = list(jbase.split_blocks(xyz, 1.5, 1.0, 0.2, 50))
    assert len(got) == len(ref) > 4
    for (i, c), (j, d) in zip(got, ref):
        np.testing.assert_array_equal(i, j)
        np.testing.assert_array_equal(c, d)
    for n, target in ((100, 64), (40, 64)):
        np.testing.assert_array_equal(
            base.fixed_size_choice(n, target, np.random.default_rng(1)),
            jbase.fixed_size_choice(n, target, np.random.default_rng(1)))


# ---------------------------------------------------------------------------
# the six datasets' readers
# ---------------------------------------------------------------------------


def _datasets(name):
    """(writer, constructor) of one reader; the constructor takes the
    dataset package (the JAX package's or the port's) and a root."""
    return {
        "s3dis_room": (write_s3dis, lambda d, r: d.S3DISRoom(
            r, test_area=5, grid_size=0.2, num_points=256,
            sample_per_epoch=4, train=False)),
        "s3dis_room_train": (write_s3dis, lambda d, r: d.S3DISRoomDataset(
            r, grid_size=0.2, num_points=256).train_set),
        "s3dis_block": (write_s3dis, lambda d, r: d.S3DISBlockDataset(
            r, train=True, test_area=5, num_points=128)),
        "semantic3d": (write_semantic3d, lambda d, r: d.Semantic3D(
            r, "train", grid_size=0.4, num_points=128, sample_per_epoch=2)),
        "semantic3d_val": (write_semantic3d, lambda d, r: d.Semantic3D(
            r, "val", grid_size=0.4, num_points=128, sample_per_epoch=2)),
        "semantic3d_test": (write_semantic3d, lambda d, r: d.Semantic3D(
            r, "test", grid_size=0.4, num_points=128, sample_per_epoch=2)),
        "semantic3d_block": (write_semantic3d, lambda d, r:
                             d.Semantic3DBlockDataset(r, "train",
                                                      num_points=256,
                                                      grid_size=0.05)),
        "scannet": (write_scannet, lambda d, r: d.ScanNetDataset(
            r, train=True, num_points=128)),
        "npm3d": (write_npm3d, lambda d, r: d.NPM3DDataset(
            r, train=True, num_points=128)),
        "npm3d_test": (write_npm3d, lambda d, r: d.NPM3DDataset(
            r, train=False, num_points=128)),
        "kitti": (write_kitti, lambda d, r: d.SemanticKITTIDataset(
            r, sequences="train", num_points=256)),
        "kitti_valid": (write_kitti, lambda d, r: d.SemanticKITTIDataset(
            r, sequences="val", num_points=256)),
        "shapenet": (write_shapenet, lambda d, r: d.ShapeNetNormalDataset(
            r, train=True, num_points=256)),
        "shapenet_test": (write_shapenet, lambda d, r:
                          d.ShapeNetNormalDataset(r, train=False,
                                                  num_points=256)),
    }[name]


def _assert_same_tree(a: Path, b: Path):
    """Two processed directories hold the same files with the same
    arrays."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb and fa
    for rel in fa:
        if rel.suffix == ".npz":
            x, y = np.load(a / rel), np.load(b / rel)
            assert sorted(x.files) == sorted(y.files), rel
            for k in x.files:
                assert x[k].dtype == y[k].dtype, (rel, k)
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{rel} {k}")
        elif rel.suffix == ".ply":
            x, y = jply.read_ply(str(a / rel)), jply.read_ply(str(b / rel))
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{rel} {k}")
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


@pytest.mark.parametrize("name", [
    "s3dis_room", "s3dis_room_train", "s3dis_block", "semantic3d",
    "semantic3d_val", "semantic3d_test", "semantic3d_block", "scannet",
    "npm3d", "npm3d_test", "kitti", "kitti_valid", "shapenet",
    "shapenet_test",
])
def test_reader_matches_jax(tmp_path, name):
    """The same raw files, processed apart by each package: the same
    processed files and the same samples from the same generators."""
    from crfconv_tpu.data import datasets as jdatasets
    from crfconv_tpu_torch.data import datasets

    write, make = _datasets(name)
    write(str(tmp_path / "jax"), np.random.default_rng(6))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    ref = make(jdatasets, str(tmp_path / "jax"))
    got = make(datasets, str(tmp_path / "port"))
    if (tmp_path / "jax" / "processed").exists():
        _assert_same_tree(tmp_path / "jax" / "processed",
                          tmp_path / "port" / "processed")
    assert len(got) == len(ref) > 0
    for i in range(6):
        a = got.get_sample(np.random.default_rng(i))
        b = ref.get_sample(np.random.default_rng(i))
        assert a.keys() == b.keys()
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")


def test_kitti_yaml_config_matches_jax(tmp_path):
    """With a semantic-kitti.yaml beside the scans its learning map and
    split are read (PyYAML, imported only then)."""
    from crfconv_tpu.data.datasets import semantickitti as jkitti
    from crfconv_tpu_torch.data.datasets import semantickitti as kitti

    path = tmp_path / "semantic-kitti.yaml"
    path.write_text("learning_map:\n  0: 0\n  10: 1\n  40: 2\n  252: 1\n"
                    "split:\n  train: [0, 1]\n  valid: [8]\n  test: [11]\n")
    (lut, split), (jlut, jsplit) = (m.load_config(str(path))
                                    for m in (kitti, jkitti))
    np.testing.assert_array_equal(lut, jlut)
    assert split == jsplit == {"train": [0, 1], "valid": [8], "test": [11]}
    np.testing.assert_array_equal(
        kitti._build_lut(kitti.DEFAULT_LEARNING_MAP),
        jkitti._build_lut(jkitti.DEFAULT_LEARNING_MAP))
    assert kitti.DEFAULT_SPLIT == jkitti.DEFAULT_SPLIT


def test_float_parse_matches_pandas(tmp_path):
    """The readers parse text with numpy where the JAX package uses pandas;
    on floats of nine significant digits both give the same float32."""
    import pandas as pd

    from crfconv_tpu_torch.data.datasets import semantic3d

    rng = np.random.default_rng(7)
    vals = rng.standard_normal((20000, 4)) * 10.0 ** rng.integers(-3, 4,
                                                                  (20000, 4))
    path = tmp_path / "floats.txt"
    np.savetxt(path, vals, fmt="%.9g")
    ref = pd.read_csv(path, header=None, sep=r"\s+",
                      dtype=np.float32).values
    np.testing.assert_array_equal(semantic3d._read_txt(str(path), np.float32),
                                  ref)
    ref64 = pd.read_csv(path, header=None, sep=r"\s+").values
    np.testing.assert_array_equal(
        np.loadtxt(path, dtype=np.float64, ndmin=2).astype(np.float32),
        ref64.astype(np.float32))


def test_readers_need_no_pandas_or_yaml(tmp_path):
    """With pandas and PyYAML unimportable, the port's readers process and
    sample S3DIS rooms and ShapeNet shapes, and SemanticKITTI scans take the
    default learning map."""
    write_s3dis(str(tmp_path / "s3dis"), np.random.default_rng(1))
    write_shapenet(str(tmp_path / "shapenet"), np.random.default_rng(2))
    write_kitti(str(tmp_path / "kitti"), np.random.default_rng(3))
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['yaml'] = None\n"
        "import numpy as np\n"
        "from crfconv_tpu_torch.data import datasets\n"
        f"root = {str(tmp_path)!r}\n"
        "s = datasets.S3DISRoomDataset(root + '/s3dis', grid_size=0.2,"
        " num_points=256).train_set.get_sample(np.random.default_rng(0))\n"
        "assert s['pos'].shape == (256, 3)\n"
        "d = datasets.ShapeNetNormalDataset(root + '/shapenet', train=True,"
        " num_points=256)\n"
        "x = d.get_sample(np.random.default_rng(0))['x']\n"
        "assert x.shape == (256, 6)\n"
        "k = datasets.SemanticKITTIDataset(root + '/kitti', num_points=64)\n"
        "assert k.num_classes == 19 and len(k.filelist) == 2\n"
        "bad = [m for m in ('pandas', 'yaml') if sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env={**os.environ, "OMP_NUM_THREADS": "2"})
