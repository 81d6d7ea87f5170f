"""The hop expansion (`ops/graph_hop.py`) against the JAX reference, on
the CPU: the same padded adjacency (random, with sentinel slots), seeds,
scores and node masks through both. Tolerance: none. Visited ids and hop
tags are equal, including which nodes a beam keeps when scores tie
(`lax.top_k`'s order, toward the lower position); reachability and first
hops are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.ops import graph_hop as jhop
from rag_application_tpu_torch.ops import graph_hop as thop

N, D = 120, 6


def graph(seed):
    r = np.random.default_rng(seed)
    adj = r.integers(0, N, size=(N + 1, D)).astype(np.int32)
    adj[r.random((N + 1, D)) < 0.3] = N  # empty slots
    adj[N] = N  # the sentinel row
    adj[r.integers(0, N, 10)] = N  # isolated nodes
    return adj


def seeds(seed, q=5, s=3):
    r = np.random.default_rng(seed)
    out = r.integers(0, N, size=(q, s)).astype(np.int32)
    out[0, 1:] = N  # padding
    out[3, 2] = out[3, 0]  # a repeated seed
    return out


def scores(seed):
    # a few distinct values, so beams cut through ties
    r = np.random.default_rng(seed)
    return np.round(r.random(N + 1) * 4).astype(np.float32) / 4


def node_mask(seed):
    r = np.random.default_rng(seed)
    m = r.random(N + 1) < 0.8
    m[N] = True
    return m


@pytest.mark.parametrize("hops", [1, 2, 3])
@pytest.mark.parametrize("cap", [4, 64])
@pytest.mark.parametrize("with_scores", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_k_hop_expand(hops, cap, with_scores, with_mask):
    adj, sd = graph(hops), seeds(cap)
    sc = scores(7) if with_scores else None
    nm = node_mask(11) if with_mask else None
    jv, jh = jhop.k_hop_expand(
        jnp.asarray(adj), jnp.asarray(sd), hops, frontier_cap=cap,
        scores=None if sc is None else jnp.asarray(sc),
        node_mask=None if nm is None else jnp.asarray(nm))
    tv, th = thop.k_hop_expand(
        torch.from_numpy(adj), torch.from_numpy(sd), hops, frontier_cap=cap,
        scores=None if sc is None else torch.from_numpy(sc),
        node_mask=None if nm is None else torch.from_numpy(nm))
    assert tv.dtype == th.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    # the expansion reaches past the seeds
    assert (th.numpy() == hops).any()


@pytest.mark.parametrize("hops", [0, 1, 2, 3])
def test_path_reachability_and_first_hop(hops):
    adj = graph(20 + hops)
    r = np.random.default_rng(hops)
    src = r.integers(0, N, 40).astype(np.int32)
    dst = r.integers(0, N, 40).astype(np.int32)
    src[:3] = N  # sentinel sources
    dst[3:6] = N  # sentinel targets
    dst[6:9] = src[6:9]  # src == dst
    # neighbours of a source: reachable in one hop
    dst[9:12] = adj[src[9:12], 0]
    ja, js, jd = jnp.asarray(adj), jnp.asarray(src), jnp.asarray(dst)
    ta, ts, td = (torch.from_numpy(x) for x in (adj, src, dst))
    reach = thop.path_reachability(ta, ts, td, hops)
    np.testing.assert_array_equal(
        reach.numpy(), np.asarray(jhop.path_reachability(ja, js, jd, hops)))
    first = thop.path_first_hop(ta, ts, td, hops)
    np.testing.assert_array_equal(
        first.numpy(), np.asarray(jhop.path_first_hop(ja, js, jd, hops)))
    if hops:
        assert (first.numpy() == 1).any() and (first.numpy() == 0).any()
