"""The plain reference: the benchmark's own PyTorch version of each
configuration's model, its windowed pyramid, its loss and its optimizer.

It imports nothing of the program and no JAX, runs no kernel, and takes
only what the benchmark hands both sides: the inputs, the subsampling
offsets, the weights and the dropout masks. Each model module names the
configurations' ``reference`` key and exposes ``param_spec(cfg)``,
``forward(W, x, scales, cfg, train, mm, keep)`` and
``forward_flops(cfg)``.
"""
