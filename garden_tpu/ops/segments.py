"""Sorted-run segment utilities shared by the raster binning and the
physics broadphase (both bucket work by sorting keyed records and then
fetching per-key contiguous runs)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray


def run_edges(key_sorted: Array, n_probes: int) -> Array:
    """searchsorted(key_sorted, arange(n_probes), side="left") as a dense
    two-level count: edges[k] = #(entries < k).

    jnp.searchsorted lowers to a while-loop binary search — ~21 serial
    dispatches of tiny gathers. Here: block maxima of the sorted keys
    give each probe its boundary block with ONE dense compare+reduce,
    then one (P, stride) row gather + a second compare+reduce finishes
    the exact count inside that block — 4 fused ops, no loops.
    Stride ~ sqrt(n) balances the block-maxima compare (P * n/stride)
    against the window fetch (P * stride)."""
    n = key_sorted.shape[0]
    stride = int(2 ** int(round(np.log2(max(np.sqrt(n), 2.0)))))
    stride = max(128, min(stride, 8192))
    pad = (-n) % stride
    if pad:
        key_p = jnp.concatenate(
            [key_sorted,
             jnp.full((pad,), jnp.iinfo(jnp.int32).max, key_sorted.dtype)])
    else:
        key_p = key_sorted
    nb = key_p.shape[0] // stride
    blocks = key_p.reshape(nb, stride)
    probes = jnp.arange(n_probes, dtype=key_sorted.dtype)[:, None]
    # blocks fully below the probe (block maxima are sorted too)
    c = jnp.sum((blocks[:, -1][None, :] < probes).astype(jnp.int32), axis=1)
    # exact count inside the boundary block (padded MAX entries never
    # count; when c == nb the clip double-counts the last block but the
    # base alone is already >= n, so the min() clamp restores exactness)
    win = blocks[jnp.clip(c, 0, nb - 1)]                 # (P, stride)
    edges = c * stride + jnp.sum((win < probes).astype(jnp.int32), axis=1)
    return jnp.minimum(edges, n).astype(jnp.int32)
