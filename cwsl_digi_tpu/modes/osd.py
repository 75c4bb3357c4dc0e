"""Ordered-statistics decoding (OSD): the deep-decode fallback after BP.

The reference's "deep" decode depth (``jt9 -d 3``, config.ini:213-215, spawn
flags at source/DecoderPool.hpp:634-659) buys its extra ~1-1.5 dB at the
threshold from an ordered-statistics pass that runs when belief propagation
fails: re-derive the codeword from hard decisions on the k most reliable
*independent* bit positions, then search a small set of low-weight flip
patterns over the least reliable of those positions, keeping the codeword
with minimum soft distance to the received word.

Device formulation
------------------
OSD is usually written as sequential Gaussian elimination per word — a poor
fit for SIMD.  Here the whole pass is one batched device program:

- bit reliabilities sorted with one ``argsort`` per word;
- GF(2) elimination over the reliability-permuted generator matrix as a
  ``lax.fori_loop`` over the n columns with masked row-swap / row-xor updates
  (all words advance in lockstep; a word whose pivot search fails at a column
  simply doesn't advance its pivot row);
- the T flip patterns become one ``[T, k] @ [k, n]`` matmul per word
  (batched via einsum), and the soft-distance arg-min is a reduction.

False-decode control: OSD always produces *some* codeword, so acceptance is
gated on (a) the payload CRC, (b) the hard-error count against the received
hard decisions, and (c) the weighted soft distance relative to total
reliability — thresholds calibrated so pure-noise windows stay clean (see
tests/test_ft8.py zero-false tests).
"""

from __future__ import annotations

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def flip_patterns(k: int, n_singles: int, tail2: int, tail3: int) -> np.ndarray:
    """Static flip-pattern table [T, k] over basis coordinates.

    Coordinate 0 is the *most* reliable basis position; flips concentrate at
    the tail (least reliable).  Pattern set: the zero pattern, single flips
    over the ``n_singles`` least reliable positions, pairs over the last
    ``tail2``, triples over the last ``tail3``.
    """
    pats = [np.zeros(k, np.uint8)]
    for i in range(k - 1, max(k - 1 - n_singles, -1), -1):
        p = np.zeros(k, np.uint8)
        p[i] = 1
        pats.append(p)
    for i, j in itertools.combinations(range(k - tail2, k), 2):
        if i >= 0:
            p = np.zeros(k, np.uint8)
            p[i] = p[j] = 1
            pats.append(p)
    for tri in itertools.combinations(range(k - tail3, k), 3):
        if tri[0] >= 0:
            p = np.zeros(k, np.uint8)
            p[list(tri)] = 1
            pats.append(p)
    return np.stack(pats)


def _osd_one(gen: jax.Array, llr: jax.Array, patterns: jax.Array):
    """OSD for one word. gen [k, n] int32, llr [n], patterns [T, k] f32.

    Returns (codeword [n] int8, soft distance, hard-error count).
    """
    k, n = gen.shape
    w = -(-n // 32)                        # packed words per row
    rel = jnp.abs(llr)
    perm = jnp.argsort(-rel)               # most reliable first
    rows = jnp.arange(k)
    # BIT-PACK the permuted generator: the elimination loop's state drops
    # from k*n bytes to k*ceil(n/32) words, so the ~k sequential steps
    # (each a full pass over the state) shrink ~7x in memory traffic.
    # Column c lives at bit (c & 31) of word (c >> 5).
    shift = jnp.uint32(1) << (jnp.arange(n, dtype=jnp.uint32) % 32)
    gperm = gen[:, perm].astype(jnp.uint32)
    pad = w * 32 - n
    gp_bits = jnp.pad(gperm * shift[None, :], ((0, 0), (0, pad)))
    gp = gp_bits.reshape(k, w, 32).sum(axis=2).astype(jnp.uint32)

    def col_step(carry):
        gp, r, c = carry
        wi = (c >> 5).astype(jnp.int32)
        bit = (c & 31).astype(jnp.uint32)
        col = (jax.lax.dynamic_index_in_dim(gp, wi, axis=1, keepdims=False)
               >> bit) & 1
        cand = (col == 1) & (rows >= r)
        has = jnp.any(cand)
        p = jnp.argmax(cand)               # first available pivot row
        # swap rows r <-> p (identity when no pivot)
        src = jnp.where(rows == r, p, jnp.where(rows == p, r, rows))
        gp = jnp.where(has, gp[src], gp)
        pivot_row = gp[r]
        col2 = (jax.lax.dynamic_index_in_dim(gp, wi, axis=1, keepdims=False)
                >> bit) & 1
        elim = (col2 == 1) & (rows != r) & has
        gp = jnp.where(elim[:, None], gp ^ pivot_row[None, :], gp)
        return gp, r + has.astype(jnp.int32), c + 1

    # loop until k pivots are placed (or columns run out): with k=91 of
    # n=174 the expected column count is ~k + a few — a while_loop saves
    # nearly half a fixed n-iteration loop
    gp, _, _ = jax.lax.while_loop(
        lambda s: (s[1] < k) & (s[2] < n), col_step,
        (gp, jnp.int32(0), jnp.int32(0)))
    # unpack to [k, n] 0/1 for the pattern matmul below
    gp = ((gp[:, :, None] >> jnp.arange(32, dtype=jnp.uint32)[None, None, :])
          & 1).reshape(k, w * 32)[:, :n].astype(jnp.uint8)
    # gp is now systematic over its pivot columns; recover them: pivot column
    # of row i is the first set bit (all other rows were eliminated there).
    basis = jnp.argmax(gp, axis=1)         # [k], increasing

    llr_p = llr[perm]
    y = (llr_p < 0).astype(jnp.float32)    # received hard decisions
    w = jnp.abs(llr_p)
    d = y[basis]                           # [k] hard decisions on the basis
    cands = jnp.mod(d[None, :] + patterns, 2.0)         # [T, k]
    cw = jnp.mod(
        jnp.dot(cands, gp.astype(jnp.float32),
                preferred_element_type=jnp.float32), 2.0)  # [T, n]
    mism = jnp.abs(cw - y[None, :])
    dist = mism @ w                        # [T]
    best = jnp.argmin(dist)
    cw_best = cw[best]
    out = jnp.zeros((n,), jnp.int8).at[perm].set(cw_best.astype(jnp.int8))
    return out, dist[best], jnp.sum(mism[best]).astype(jnp.int32)


@jax.jit
def osd_decode(
    gen: jax.Array,        # [k, n] 0/1 generator matrix (rows span the code)
    llrs: jax.Array,       # [M, n] (positive = bit 0)
    patterns: jax.Array,   # [T, k] float32 flip patterns (basis coordinates)
):
    """Batched OSD. Returns (codewords [M, n] int8, dist [M], nhard [M])."""
    gen = gen.astype(jnp.int32)
    return jax.vmap(lambda l: _osd_one(gen, l, patterns))(llrs)
