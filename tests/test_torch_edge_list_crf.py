"""The edge-list continuous CRF of crfconv_tpu_torch against the JAX package
on the CPU: ``edges_to_padded`` bit for bit (duplicate edges, destinations
with more edges than ``max_degree``, destinations with none), and
``EdgeListContinuousCRFConv`` with the same weights (``from_flax``) in eval
and in train mode (batch statistics over the cloud's points, running
statistics updated)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.models.crf_conv import EdgeListContinuousCRFConv as JEdge
from crfconv_tpu.models.crf_conv import edges_to_padded as j_edges_to_padded
from crfconv_tpu_torch import from_flax
from crfconv_tpu_torch.models.crf_conv import (
    EdgeListContinuousCRFConv, edges_to_padded,
)
from tests.test_torch_model import _perturb_stats, _t
from tests.test_torch_ops import few_torch_threads  # noqa: F401

N_NODES, N_EDGES, STEPS = 64, 400, 3


def _edges(seed: int) -> np.ndarray:
    """[2, 400] (destination, source) rows: random edges, 30 repeated ones,
    40 edges into node 5 (more than 32), and no edge into node 63."""
    rng = np.random.default_rng(seed)
    n_rand = N_EDGES - 30 - 40
    i = rng.integers(0, N_NODES - 1, n_rand)
    j = rng.integers(0, N_NODES, n_rand)
    dup = rng.integers(0, n_rand, 30)
    i = np.concatenate([i, i[dup], np.full(40, 5)])
    j = np.concatenate([j, j[dup], rng.integers(0, N_NODES, 40)])
    perm = rng.permutation(N_EDGES)
    return np.stack([i[perm], j[perm]]).astype(np.int32)


@pytest.mark.parametrize("max_degree", [4, 32])
def test_edges_to_padded_matches_jax(max_degree):
    edges = _edges(0)
    ref_nbr, ref_mask = j_edges_to_padded(jnp.asarray(edges), N_NODES,
                                          max_degree)
    nbr, mask = edges_to_padded(torch.from_numpy(edges), N_NODES, max_degree)
    assert nbr.dtype == torch.int32 and mask.dtype == torch.bool
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(ref_nbr))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    counts = np.bincount(edges[0], minlength=N_NODES)
    assert counts[5] > max_degree and counts[63] == 0
    np.testing.assert_array_equal(mask.sum(1).numpy(),
                                  np.minimum(counts, max_degree))
    # node 5 keeps its first max_degree edges, in edge order
    np.testing.assert_array_equal(nbr[5].numpy(),
                                  edges[1][edges[0] == 5][:max_degree])


def test_edges_to_padded_rejects_bad_destinations():
    edges = torch.tensor([[0, 64], [1, 2]])
    with pytest.raises(ValueError, match="destinations"):
        edges_to_padded(edges, 64, 4)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("channels", [8, 16])
def test_edge_list_crf_matches_jax(channels, train):
    rng = np.random.default_rng(channels)
    x = rng.standard_normal((N_NODES, channels)).astype(np.float32)
    y = rng.standard_normal((N_NODES, channels)).astype(np.float32)
    pos = rng.random((N_NODES, 3)).astype(np.float32)
    edges = _edges(channels)
    jargs = tuple(map(jnp.asarray, (x, y, pos, edges)))
    model = JEdge(unary_channels=channels, pairwise_channels=channels,
                  steps=STEPS)
    with jax.default_matmul_precision("highest"):
        variables = model.init(jax.random.PRNGKey(0), *jargs, train=False)
        hidden = channels // 4
        params = dict(variables["params"])
        params["c"] = params["c"] + 0.1 * jnp.asarray(
            rng.standard_normal((hidden, hidden)).astype(np.float32))
        variables = {"params": params,
                     "batch_stats": _perturb_stats(variables["batch_stats"])}
        if train:
            ref, upd = model.apply(variables, *jargs, train=True,
                                   mutable=["batch_stats"])
        else:
            ref = model.apply(variables, *jargs, train=False)
    port = EdgeListContinuousCRFConv(channels, channels, steps=STEPS,
                                     device="cpu")
    port.load_state_dict(from_flax(jax.device_get(variables["params"]),
                                   jax.device_get(variables["batch_stats"])))
    port.train(train)
    got = port(*map(_t, (x, y, pos, edges)))
    assert got.shape == (N_NODES, channels)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)
    if train:   # the running statistics moved as the JAX ones did
        new = from_flax(jax.device_get(variables["params"]),
                        jax.device_get(upd["batch_stats"]))
        sd = port.state_dict()
        for k in new:
            if k.endswith((".bn.mean", ".bn.var")):
                np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(),
                                           rtol=2e-4, atol=1e-6, err_msg=k)


def test_edge_list_crf_init_and_channel_check():
    m = EdgeListContinuousCRFConv(8, 16, device="cpu")
    assert tuple(m.c.shape) == (4, 4)      # out 16, hidden 16 // 4
    assert torch.equal(m.c, torch.eye(4))
    assert m.fusion_net.weight.abs().max() <= 1 / np.sqrt(32)
    with pytest.raises(ValueError, match="channels"):
        m(torch.zeros(4, 7), torch.zeros(4, 16), torch.zeros(4, 3),
          torch.zeros(2, 1, dtype=torch.long))
