"""``python -m crfconv_tpu_torch.train --n-devices 2 --device cpu``
spawning its two gloo ranks (the data-parallel steps and the Trainer on
two ranks are tests/test_torch_parallel.py's)."""

from __future__ import annotations

from crfconv_tpu_torch.train import __main__ as cli
from tests.test_torch_parallel import s3dis_root  # noqa: F401


def test_cli_spawns_the_ranks(s3dis_root, tmp_path, monkeypatch):
    """``--n-devices 2 --device cpu --backend gloo`` trains on two spawned
    ranks (one torch thread each) and returns rank 0's best mIoU; rank 0
    wrote the checkpoints."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    best = cli.main([
        "--dataset", "S3DIS", "--root", s3dis_root, "--mode", "train",
        "--epochs", "1", "--batch-size", "1", "--no-crf",
        "--n-devices", "2", "--device", "cpu", "--backend", "gloo",
        "--set", "sample_num=256", "--set", "grid_size=0.2",
        "--set", "train_samples_per_epoch=4",
        "--set", "val_samples_per_epoch=2",
        "--set", f"checkpoint_dir={tmp_path}"])
    assert 0.0 <= best <= 1.0
    written = [f for d in tmp_path.iterdir() for f in d.iterdir()]
    assert any(f.name == "ckpt_best.pt" for f in written)
