"""Utilities: device timing, the logger setup, tracing and visualization
(``profiling``, ``visualization``)."""

from crfconv_tpu_torch.utils.benchtools import device_time  # noqa: F401
from crfconv_tpu_torch.utils.logging import init_logger  # noqa: F401
