"""``kernel_roofline.<kind>``: over the program's own CUDA kernels in the
profiled slice, the sum of each wrapper call's least time (``bounds.py``)
over the sum of their device time, in %."""


def read(r):
    sl = r.slice
    if not sl or not sl["wrapper_calls"] or sl["csrc_device_s"] <= 0:
        return None
    return 100.0 * sl["bound_s"] / sl["csrc_device_s"]
