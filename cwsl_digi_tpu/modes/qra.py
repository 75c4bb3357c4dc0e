"""Q-ary sparse code over GF(64) + batched sum-product decoder (device).

The real Q65 inner code is QRA(63,13): a q-ary repeat-accumulate code over
GF(64) decoded with full symbol-probability message passing — that soft
decoder, fed per-tone energies, is where Q65's sensitivity comes from (the
reference gets it from jt9 -3, source/DecoderPool.hpp:645-647).  This module
provides the native equivalent:

- ``build_qra_code``: a deterministic sparse parity-check code over GF(64)
  with the exact (n, k) = (63, 13) and a low-density edge profile (info
  columns weight 3, parity columns weight 2), random nonzero GF edge
  coefficients, 4-cycle-free; columns arranged so a systematic encoder
  exists.  Same stand-in policy as the binary LDPC codes (modes/ldpc.py):
  rate/length/alphabet/degree-profile match gives the same waterfall; drop
  the published QRA matrix in for on-air interop.
- ``QaryMPDecoder``: batched sum-product over GF(64) in the probability
  domain.  Check nodes convolve symbol distributions under GF addition
  (= XOR), done with a 64-point Walsh-Hadamard transform as one [64, 64]
  matmul; GF edge coefficients are static permutations of the symbol
  axis.  Fixed iteration count, no data-dependent control flow.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from cwsl_digi_tpu.modes.rs64 import _tables

Q = 64


# ---------------------------------------------------------------------------
# GF(64) vector helpers (host)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _mul_table() -> np.ndarray:
    """[64, 64] GF(64) multiplication table."""
    exp, log = _tables()
    t = np.zeros((Q, Q), np.int64)
    a = np.arange(1, Q)
    la = log[a]
    for b in range(1, Q):
        t[a, b] = exp[la + log[b]]
    return t


def gf_mul(a, b):
    return _mul_table()[a, b]


def gf_inv(a: int) -> int:
    exp, log = _tables()
    return int(exp[(63 - log[a]) % 63])


@functools.lru_cache(maxsize=1)
def _wht64() -> np.ndarray:
    """64-point Walsh-Hadamard matrix (+-1), H @ H = 64 I.

    WHT diagonalizes convolution under GF(2^6) addition (bitwise XOR of
    symbol indices): conv_xor(p, q) = IWHT(WHT(p) * WHT(q)) / 64.
    """
    h = np.array([[1.0]])
    for _ in range(6):
        h = np.block([[h, h], [h, -h]])
    return h.astype(np.float32)


# ---------------------------------------------------------------------------
# Code construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QRACode:
    """Sparse GF(64) code. Codeword symbols = [info(k) | parity(n-k)]."""

    n: int
    k: int
    h_vars: np.ndarray     # [n_checks, max_row] var index (pad = n)
    h_coeff: np.ndarray    # [n_checks, max_row] GF coefficient (pad = 1)
    row_mask: np.ndarray   # [n_checks, max_row] 1.0 for real slots
    gen: np.ndarray        # [k, n-k] GF: parity = "info @ gen" over GF(64)

    @property
    def n_checks(self) -> int:
        return self.n - self.k

    def encode(self, info: np.ndarray) -> np.ndarray:
        info = np.asarray(info, np.int64)
        mt = _mul_table()
        parity = np.zeros(self.n - self.k, np.int64)
        for j in range(self.n - self.k):
            acc = 0
            for i in range(self.k):
                acc ^= int(mt[info[i], self.gen[i, j]])
            parity[j] = acc
        return np.concatenate([info, parity])

    def syndrome_ok(self, word: np.ndarray) -> bool:
        mt = _mul_table()
        for c in range(self.n_checks):
            acc = 0
            for s in range(self.h_vars.shape[1]):
                if self.row_mask[c, s]:
                    acc ^= int(mt[word[self.h_vars[c, s]],
                                  self.h_coeff[c, s]])
            if acc:
                return False
        return True


def _gf_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray | None:
    """Solve A X = B over GF(64); A [m, m], B [m, r]; None if singular."""
    mt = _mul_table()
    a = a.copy().astype(np.int64)
    b = b.copy().astype(np.int64)
    m = a.shape[0]
    for c in range(m):
        piv = None
        for r in range(c, m):
            if a[r, c]:
                piv = r
                break
        if piv is None:
            return None
        if piv != c:
            a[[c, piv]] = a[[piv, c]]
            b[[c, piv]] = b[[piv, c]]
        inv = gf_inv(int(a[c, c]))
        a[c] = mt[a[c], inv]
        b[c] = mt[b[c], inv]
        for r in range(m):
            if r != c and a[r, c]:
                f = int(a[r, c])
                a[r] ^= mt[a[c], f]
                b[r] ^= mt[b[c], f]
    return b


def build_qra_code(n: int = 63, k: int = 13, seed: int = 65,
                   info_w: int = 3, parity_w: int = 2) -> QRACode:
    """Deterministic sparse GF(64) code with a systematic encoder.

    Info columns get weight ``info_w``, parity columns ``parity_w``, checks
    near-uniform, no 4-cycles (no two columns share two checks), random
    nonzero GF coefficients.  Retries seeds until the parity square is
    invertible.
    """
    n_checks = n - k
    for attempt in range(256):
        rng = np.random.default_rng(seed + attempt)
        cols: list[np.ndarray] = []
        row_fill = np.zeros(n_checks, np.int64)
        pair_seen: set[tuple[int, int]] = set()
        ok = True
        for c in range(n):
            w = info_w if c < k else parity_w
            for _try in range(200):
                noise = rng.random(n_checks)
                order = np.lexsort((noise, row_fill))
                pick = np.sort(order[:w])
                pairs = [(int(pick[i]), int(pick[j]))
                         for i in range(w) for j in range(i + 1, w)]
                if all(p not in pair_seen for p in pairs):
                    pair_seen.update(pairs)
                    break
            else:
                ok = False
                break
            cols.append(pick)
            row_fill[pick] += 1
        if not ok or np.any(row_fill == 0):
            continue
        # dense H over GF for the encoder solve
        h = np.zeros((n_checks, n), np.int64)
        for c, pick in enumerate(cols):
            for r in pick:
                h[r, c] = int(rng.integers(1, Q))
        try:
            return code_from_dense(h, k)
        except ValueError:
            continue
    raise RuntimeError("failed to construct q-ary code")


def code_from_dense(h: np.ndarray, k: int) -> QRACode:
    """Build a :class:`QRACode` from a dense GF(64) parity matrix
    ``[n_checks, n]`` (0 = no edge) with info columns first.

    This is the entry point for the PUBLISHED Q65 QRA(63,13) matrix
    (supplied via CWSL_DIGI_TPU_TABLES_DIR/q65_qra_63_13.txt,
    modes/tables_ext.py) as well as the stand-in construction above."""
    h = np.asarray(h, np.int64)
    n_checks, n = h.shape
    if k != n - n_checks:
        raise ValueError(f"H shape {h.shape} inconsistent with k={k}")
    bmat = h[:, k:]
    amat = h[:, :k]
    sol = _gf_solve(bmat, amat)        # [n_checks, k]: parity = sol @ info
    if sol is None:
        raise ValueError("parity block of H is singular over GF(64); "
                         "supply H with info columns first")
    # sparse row tables
    rows = [np.nonzero(h[i])[0] for i in range(n_checks)]
    max_row = max(len(r) for r in rows)
    h_vars = np.full((n_checks, max_row), n, np.int32)
    h_coeff = np.ones((n_checks, max_row), np.int32)
    row_mask = np.zeros((n_checks, max_row), np.float32)
    for i, r in enumerate(rows):
        h_vars[i, : len(r)] = r
        h_coeff[i, : len(r)] = h[i, r]
        row_mask[i, : len(r)] = 1.0
    return QRACode(n=n, k=k, h_vars=h_vars, h_coeff=h_coeff,
                   row_mask=row_mask, gen=sol.T.astype(np.int64))


# ---------------------------------------------------------------------------
# Batched sum-product decoder (device)
# ---------------------------------------------------------------------------

class QaryMPDecoder:
    """Batched GF(64) sum-product in the probability domain.

    Messages are [batch, n_checks, max_row, 64] distributions.  Check
    update: permute each incoming message by its GF coefficient, WHT,
    leave-one-out product across the check's slots, inverse WHT, permute
    back.  Variable update: channel likelihood times incoming extrinsics.
    Padded slots carry uniform distributions so they are exact no-ops.
    """

    def __init__(self, code: QRACode, iters: int = 33):
        self.code = code
        self.iters = iters
        mt = _mul_table()
        nc, mr = code.h_vars.shape
        n = code.n
        # symbol-permutation tables per edge slot:
        # fwd[c,s,t] = index v such that coeff*v = t  (var -> check domain)
        inv_c = np.array([0] + [gf_inv(g) for g in range(1, Q)], np.int64)
        coeff = code.h_coeff.astype(np.int64)
        self._fwd = mt[inv_c[coeff][:, :, None], np.arange(Q)[None, None, :]]
        # bwd[c,s,t] = coeff*t (check -> var domain index of symbol t)
        self._bwd = mt[coeff[:, :, None], np.arange(Q)[None, None, :]]
        # variable-side gather: edges incident to each var (flat slot ids)
        slots = [[] for _ in range(n)]
        for c in range(nc):
            for s in range(mr):
                if code.row_mask[c, s]:
                    slots[int(code.h_vars[c, s])].append(c * mr + s)
        self._max_col = max(len(s) for s in slots)
        col_slots = np.zeros((n, self._max_col), np.int32)
        col_mask = np.zeros((n, self._max_col), np.float32)
        for v, ss in enumerate(slots):
            col_slots[v, : len(ss)] = ss
            col_mask[v, : len(ss)] = 1.0
        self._col_slots = col_slots
        self._col_mask = col_mask
        self._h_vars = code.h_vars
        self._row_mask = code.row_mask

    @functools.partial(jax.jit, static_argnums=(0,))
    def decode(self, probs: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
        """probs: [B, n, 64] channel symbol likelihoods (rows normalized).

        Returns (hard symbols [B, n] int32, syndrome_ok [B] bool,
        posterior max-prob [B] — a confidence for acceptance gates).
        """
        bsz = probs.shape[0]
        code = self.code
        nc, mr = code.h_vars.shape
        n = code.n
        wht = jnp.asarray(_wht64())
        h_vars = jnp.asarray(self._h_vars)
        row_mask = jnp.asarray(self._row_mask)[None, :, :, None]
        fwd = jnp.asarray(self._fwd)
        bwd = jnp.asarray(self._bwd)
        col_slots = jnp.asarray(self._col_slots)
        col_mask = jnp.asarray(self._col_mask)
        uni = jnp.float32(1.0 / Q)

        # channel likelihoods padded with a uniform row for slot gathers
        chan = jnp.concatenate(
            [probs, jnp.full((bsz, 1, Q), uni, probs.dtype)], axis=1)

        def norm(m):
            return m / (jnp.sum(m, axis=-1, keepdims=True) + 1e-30)

        m_cv = jnp.full((bsz, nc, mr, Q), uni, jnp.float32)

        def body(_, m_cv):
            # ---- variable -> check -------------------------------------
            # posterior-style product of channel and all incoming messages
            # at each variable, then divide out own message (guarded).
            flat = m_cv.reshape(bsz, nc * mr, Q)
            inc = flat[:, col_slots.reshape(-1), :].reshape(
                bsz, n, self._max_col, Q)
            inc = jnp.where(col_mask[None, :, :, None] > 0, inc, uni)
            tot = chan[:, :n] * jnp.prod(inc, axis=2)
            tot_slot = tot[:, h_vars.clip(0, n - 1), :]       # wrong for pads
            tot_slot = jnp.where(h_vars[None, :, :, None] < n, tot_slot, uni)
            m_vc = tot_slot / (m_cv + 1e-30)
            m_vc = norm(jnp.maximum(m_vc, 1e-30)) * row_mask \
                + uni * (1.0 - row_mask)
            # ---- check -> variable (WHT domain) ------------------------
            perm = jnp.take_along_axis(m_vc, fwd[None], axis=-1)
            w = perm @ wht                                    # [B,nc,mr,Q]
            # leave-one-out product over the check's slots; w crosses zero
            # so divide-by-own is unsafe — explicit exclusion per slot
            # (max_row is small, 2-4)
            slot_ids = jnp.arange(mr)[None, None, :, None]
            loo = jnp.stack([
                jnp.prod(jnp.where((row_mask > 0) & (slot_ids != s), w, 1.0),
                         axis=2)
                for s in range(mr)], axis=2)
            new = (loo @ wht) / Q
            new = jnp.take_along_axis(new, bwd[None], axis=-1)
            new = jnp.maximum(new, 1e-30)
            new = norm(new) * row_mask + uni * (1.0 - row_mask)
            return new

        m_cv = jax.lax.fori_loop(0, self.iters, body, m_cv)

        # posterior + hard decision
        flat = m_cv.reshape(bsz, nc * mr, Q)
        inc = flat[:, col_slots.reshape(-1), :].reshape(bsz, n, self._max_col, Q)
        inc = jnp.where(col_mask[None, :, :, None] > 0, inc, uni)
        post = norm(chan[:, :n] * jnp.prod(inc, axis=2))
        hard = jnp.argmax(post, axis=-1).astype(jnp.int32)

        # syndrome over GF(64): xor of coeff*symbol per check
        mul_t = jnp.asarray(_mul_table().astype(np.int32))
        hard_pad = jnp.concatenate(
            [hard, jnp.zeros((bsz, 1), jnp.int32)], axis=1)
        sym_slot = hard_pad[:, h_vars]                        # [B, nc, mr]
        prod_slot = mul_t[sym_slot, jnp.asarray(self.code.h_coeff)[None]]
        prod_slot = jnp.where(jnp.asarray(self._row_mask)[None] > 0,
                              prod_slot, 0)
        syn = prod_slot[:, :, 0]
        for s in range(1, mr):
            syn = jnp.bitwise_xor(syn, prod_slot[:, :, s])
        ok = jnp.all(syn == 0, axis=1)
        conf = jnp.mean(jnp.max(post, axis=-1), axis=-1)
        return hard, ok, conf
