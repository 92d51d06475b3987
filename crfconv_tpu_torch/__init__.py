"""crfconv_tpu_torch: the PyTorch/CUDA port of crfconv_tpu.

The flagship continuous-CRF point-convolution U-Net served on an NVIDIA
H100, with the windowed regime's kernels written by hand in CUDA C++
(``csrc/``, built on first use by ``cuda_build``). On CPU tensors every
kernel wrapper runs its plain PyTorch version.
"""

from crfconv_tpu_torch.convert import from_flax
from crfconv_tpu_torch.models.point_conv_big import PointConvResNet
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.ops.windowed import build_pyramid_windowed
from crfconv_tpu_torch.serve import Predictor

__all__ = [
    "NeighborMode",
    "PointConvResNet",
    "Predictor",
    "build_pyramid_windowed",
    "from_flax",
]
