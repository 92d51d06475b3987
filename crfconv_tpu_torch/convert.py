"""Weight bridge: a flax variable tree (``PointConvResNet``, ``CRFSegNet``,
``CRFSegNet_Part``, ``BaselineSegNet``, ``BaselineDiscreteCRFSegNet``,
``DualCRFSegNet``, ``EdgeListContinuousCRFConv``) onto the port's module of
the same name.

The port's module names are the flax names, so the mapping is structural:

  * ``<path>/Dense_0/kernel`` [in, out] -> ``<path>.weight`` [out, in]
    (and ``Dense_0/bias`` -> ``<path>.bias`` where present);
  * ``<path>/MaskedBatchNorm_0/{scale,bias}`` and the batch statistics
    ``{mean,var}`` -> ``<path>.bn.{scale,bias,mean,var}``;
  * a bare Dense (``classifier_1``, ``classifier/fc1``) ``kernel``/``bias``
    -> ``weight``/``bias``;
  * any other leaf is copied as it is: the continuous CRF's compatibility
    ``c`` and the discrete CRF's ``crf/{F, W, C}`` (kernels, kernel
    weights, label compatibility).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_flax(params: Mapping, batch_stats: Mapping) -> dict:
    """flax ``params`` and ``batch_stats`` trees (numpy arrays) -> a state
    dict for the port's model's ``load_state_dict``."""
    out = {}

    def walk(p: Mapping, stats: Mapping, prefix: str) -> None:
        for name, v in p.items():
            if name == "Dense_0":
                out[prefix + "weight"] = _t(v["kernel"]).T.contiguous()
                if "bias" in v:
                    out[prefix + "bias"] = _t(v["bias"])
            elif name == "MaskedBatchNorm_0":
                st = stats[name]
                for key, src in (("scale", v["scale"]), ("bias", v["bias"]),
                                 ("mean", st["mean"]), ("var", st["var"])):
                    out[f"{prefix}bn.{key}"] = _t(src)
            elif name == "kernel":
                out[prefix + "weight"] = _t(v).T.contiguous()
            elif isinstance(v, Mapping):
                walk(v, stats.get(name, {}), f"{prefix}{name}.")
            else:
                out[prefix + name] = _t(v)

    walk(params, batch_stats, "")
    return out
