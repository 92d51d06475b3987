"""crfconv_tpu_torch: the PyTorch/CUDA port of crfconv_tpu.

The flagship continuous-CRF point-convolution U-Net and the small
family's ``CRFSegNet`` (continuous CRF at any number of mean-field steps),
``CRFSegNet_Part`` (ShapeNet part segmentation), ``BaselineDiscreteCRFSegNet``
and ``DualCRFSegNet`` (a discrete CRF head), all named in ``get_model``'s
registry, served and trained on an NVIDIA H100, in the windowed neighbour regime
and in the exact one (``knn_bruteforce``, ``build_pyramid_device``), with
every kernel written by hand in CUDA C++ (``csrc/``, built on first use by
``cuda_build``). On CPU tensors every kernel wrapper runs its plain
PyTorch version. The six datasets' readers (``data/datasets``), the
possibility sampler, the transforms and ``MultiscaleLoader`` feed them from
the host, with the host pyramid (``build_pyramid``) for the exact regime.
``Trainer`` (``python -m crfconv_tpu_torch.train``) runs experiments:
epochs, validation, resumable checkpoints, the vote test
(``labeled_vote_eval``), ShapeNet's part IoU and, with ``streaming_eval``,
SemanticKITTI's per-sequence eval; ``compute_dtype_scope(torch.bfloat16)``
runs the models' products in bfloat16.
"""

from crfconv_tpu_torch.convert import from_flax
from crfconv_tpu_torch.data.batch import RawBatch
from crfconv_tpu_torch.data.datasets import (
    NPM3DDataset, S3DISBlockDataset, S3DISRoom, S3DISRoomDataset,
    ScanNetDataset, Semantic3D, Semantic3DBlockDataset,
    Semantic3DWholeDataset, SemanticKITTIDataset, ShapeNetNormalDataset,
)
from crfconv_tpu_torch.data.loader import (
    MultiscaleLoader, loader_load_state_dict, loader_state_dict,
)
from crfconv_tpu_torch.data.pipeline import (
    build_pyramid, build_pyramid_device, make_batch,
)
from crfconv_tpu_torch.models import (
    BaselineDiscreteCRFSegNet, BaselineSegNet, CRFSegNet, CRFSegNet_Part,
    DualCRFSegNet, PointConvResNet, get_model,
)
from crfconv_tpu_torch.models.common import (
    compute_dtype_scope, get_compute_dtype, set_compute_dtype,
)
from crfconv_tpu_torch.ops.neighbors import NeighborMode, knn_bruteforce
from crfconv_tpu_torch.ops.windowed import (
    build_pyramid_windowed, select_min_k,
)
from crfconv_tpu_torch.serve import Predictor
from crfconv_tpu_torch.train.checkpoint import CheckpointManager
from crfconv_tpu_torch.train.kitti_eval import streaming_eval
from crfconv_tpu_torch.train.train_state import (
    TrainState, make_eval_step, make_train_step,
)
from crfconv_tpu_torch.train.trainer import Trainer
from crfconv_tpu_torch.train.vote import labeled_vote_eval

__all__ = [
    "BaselineDiscreteCRFSegNet",
    "BaselineSegNet",
    "CRFSegNet",
    "CRFSegNet_Part",
    "CheckpointManager",
    "DualCRFSegNet",
    "MultiscaleLoader",
    "NPM3DDataset",
    "NeighborMode",
    "PointConvResNet",
    "Predictor",
    "RawBatch",
    "S3DISBlockDataset",
    "S3DISRoom",
    "S3DISRoomDataset",
    "ScanNetDataset",
    "Semantic3D",
    "Semantic3DBlockDataset",
    "Semantic3DWholeDataset",
    "SemanticKITTIDataset",
    "ShapeNetNormalDataset",
    "TrainState",
    "Trainer",
    "build_pyramid",
    "build_pyramid_device",
    "build_pyramid_windowed",
    "compute_dtype_scope",
    "from_flax",
    "get_compute_dtype",
    "get_model",
    "knn_bruteforce",
    "labeled_vote_eval",
    "loader_load_state_dict",
    "loader_state_dict",
    "make_batch",
    "make_eval_step",
    "make_train_step",
    "select_min_k",
    "set_compute_dtype",
    "streaming_eval",
]
