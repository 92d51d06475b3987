"""Utilities: the logger setup."""

from crfconv_tpu_torch.utils.logging import init_logger  # noqa: F401
