"""Model modules and the model registry.

Counterpart of ``crfconv_tpu/models/__init__.py``: the reference's public
registry names (``CRFSegNet_Part``, ``BaselineSegNet``,
``BaselineDiscreteCRFSegNet``, ``CRFSegNet``, ``DualCRFSegNet``,
``PointConvBig`` = ``PointConvResNet``), looked up by :func:`get_model`.
"""

from crfconv_tpu_torch.models.point_conv_big import PointConvResNet
from crfconv_tpu_torch.models.segnets import (
    BaselineDiscreteCRFSegNet, BaselineSegNet, CRFSegNet, CRFSegNet_Part,
    DualCRFSegNet,
)

PointConvBig = PointConvResNet

_REGISTRY = {
    "PointConvBig": PointConvResNet,
    "PointConvResNet": PointConvResNet,
    "BaselineSegNet": BaselineSegNet,
    "CRFSegNet": CRFSegNet,
    "CRFSegNet_Part": CRFSegNet_Part,
    "BaselineDiscreteCRFSegNet": BaselineDiscreteCRFSegNet,
    "DualCRFSegNet": DualCRFSegNet,
}


def get_model(name: str, **kwargs):
    """The model of the reference-compatible ``name``, built with
    ``kwargs`` (the port's constructor arguments: ``n_classes``,
    ``in_channels``, ``steps``, ``device``, ``generator``, ...)."""
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown model '{name}'. Available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](**kwargs)
