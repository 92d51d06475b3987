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

:func:`load_flax_train_state` carries a JAX trainer's whole train state
into the port's ``TrainState``: the weights and statistics as above, the
optimizer's momentum (optax's ``trace``, which has the params' tree, as
SGD's momentum buffers: both are ``m_t = g_t + momentum * m_{t-1}``), the
step and the learning rate of the step's epoch. Nothing is left behind: the
JAX chain's other states are empty or the step count.
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


def set_momentum(state, momenta: Mapping, step: int) -> None:
    """Set a port ``TrainState``'s SGD momentum buffers (``momenta``, by
    parameter name) and its step, with the scheduler's learning rate at
    that step."""
    for name, p in state.model.named_parameters():
        state.optimizer.state[p]["momentum_buffer"] = (
            torch.as_tensor(momenta[name]).to(p.device, p.dtype).clone())
    state.step = step
    sched = state.scheduler
    lrs = [base * fn(step) for base, fn in zip(sched.base_lrs,
                                                sched.lr_lambdas)]
    for group, lr in zip(state.optimizer.param_groups, lrs):
        group["lr"] = lr
    sched.last_epoch = step
    sched._last_lr = lrs


def load_flax_train_state(state, jax_state) -> None:
    """A JAX ``TrainState`` (host arrays: ``params``, ``batch_stats``, the
    ``opt_state`` of the chain of ``make_optimizer`` in
    ``crfconv_tpu/train/train_state.py``, ``step``) into the port's
    ``state``, in place."""
    state.model.load_state_dict(
        from_flax(jax_state.params, jax_state.batch_stats))
    trace = next(s.trace for s in jax_state.opt_state if hasattr(s, "trace"))
    # the trace has the params' tree; the statistics the walk adds are
    # not parameters and are dropped
    set_momentum(state, from_flax(trace, jax_state.batch_stats),
                 int(jax_state.step))
