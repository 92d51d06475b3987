"""crfconv_tpu_torch: the PyTorch/CUDA port of crfconv_tpu.

The flagship continuous-CRF point-convolution U-Net and the small
family's ``CRFSegNet`` (continuous CRF at any number of mean-field steps),
``BaselineDiscreteCRFSegNet`` and ``DualCRFSegNet`` (a discrete CRF head)
served and trained on an NVIDIA H100, with the windowed regime's kernels
written by hand in CUDA C++ (``csrc/``, built on first use by
``cuda_build``). On CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""

from crfconv_tpu_torch.convert import from_flax
from crfconv_tpu_torch.data.batch import RawBatch
from crfconv_tpu_torch.models.point_conv_big import PointConvResNet
from crfconv_tpu_torch.models.segnets import (
    BaselineDiscreteCRFSegNet, BaselineSegNet, CRFSegNet, DualCRFSegNet,
)
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.ops.windowed import build_pyramid_windowed
from crfconv_tpu_torch.serve import Predictor
from crfconv_tpu_torch.train.checkpoint import CheckpointManager
from crfconv_tpu_torch.train.train_state import (
    TrainState, make_eval_step, make_train_step,
)

__all__ = [
    "BaselineDiscreteCRFSegNet",
    "BaselineSegNet",
    "CRFSegNet",
    "CheckpointManager",
    "DualCRFSegNet",
    "NeighborMode",
    "PointConvResNet",
    "Predictor",
    "RawBatch",
    "TrainState",
    "build_pyramid_windowed",
    "from_flax",
    "make_eval_step",
    "make_train_step",
]
