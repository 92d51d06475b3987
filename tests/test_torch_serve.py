"""crfconv_tpu_torch.serve.Predictor against crfconv_tpu.serve.Predictor
on the CPU: Morton sort, pyramid, forward and un-permute, with the same
weights and the same subsampling offsets."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from crfconv_tpu.data.batch import PointBatch as JBatch
from crfconv_tpu.models import PointConvResNet as JResNet
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.serve import Predictor as JPredictor
from crfconv_tpu_torch import PointConvResNet, Predictor
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from tests.test_torch_model import RNGS, _init, _load, _perturb_stats, _pyramid
from tests.test_torch_ops import jax_offsets


def test_predictor_matches_jax():
    """Predictor round trip: Morton sort, pyramid (offsets from the JAX
    key), forward and un-permute, against serve.Predictor."""
    # a cloud on which the two libraries' kNN pick identical neighbour
    # sets (they may otherwise swap a last-bit distance tie)
    rng = np.random.default_rng(2)
    n = 1024
    pos = rng.random((1, n, 3)).astype(np.float32)
    feats = rng.random((1, n, 4)).astype(np.float32)
    model = JResNet(n_classes=5, use_crf=True, steps=1,
                    layers=(8, 16, 32, 64, 128))
    key = jax.random.PRNGKey(0)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        order, scales = _pyramid(pos, key)
        x = jnp.take_along_axis(jnp.asarray(feats), order[..., None], axis=1)
        variables = _init(model, RNGS, JBatch(x=x, y=None, scales=scales))
        variables = {**variables,
                     "batch_stats": _perturb_stats(variables["batch_stats"])}
        jp = JPredictor(model, variables, key=key)
        ref = np.asarray(jp.predict_logits(jnp.asarray(pos), jnp.asarray(feats)))
    port = _load(
        PointConvResNet(5, 4, layers=(8, 16, 32, 64, 128), device="cpu"),
        variables,
    )
    p = Predictor(port, NeighborMode("windowed", knn_exact=True), device="cpu")
    offs = jax_offsets(key, n)
    got = p.predict_logits(pos, feats, offsets=offs).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    labels = p.predict(pos, feats, offsets=offs)
    assert labels.shape == (1, n)
    np.testing.assert_array_equal(labels.numpy(), ref.argmax(-1))
