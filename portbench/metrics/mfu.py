"""``mfu.<kind>``: the model operations of every request or step completed
in the window (``flops.py``, from the configuration's shapes: a forward,
or forward and backward) over the window's seconds, as a share of one
H100's float32 peak outside the tensor cores."""

from portbench.flops import PEAK_F32_OPS_PER_S


def read(r):
    if not r.units:
        return None
    return 100.0 * r.model_flops * r.units / r.window_s / PEAK_F32_OPS_PER_S
