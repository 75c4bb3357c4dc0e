"""LDPC codes and a batched min-sum belief-propagation decoder (JAX).

The FT8/FT4 protocol uses LDPC(174,91) — 174 codeword bits, 91 information
bits (77 payload + 14 CRC), 83 parity checks; FST4/FST4W use LDPC(240,101).
The reference gets these decoders from the external jt9 binary
(source/DecoderPool.hpp:634-676); here they are native device programs.

Code construction
-----------------
``ft8_code`` is the **published WSJT-X LDPC(174,91)** code, built from the
real parity table in modes/tables.py and cross-checked against the
published generator matrix — frames are bit-exact with jt9's, so the
decoder interoperates with real on-air FT8/FT4 transmissions.

``make_ldpc_code`` builds a deterministic pseudo-random column-weight-3
parity-check matrix with the exact (n, k) of a protocol code and
rearranges columns so a systematic encoder exists.  It is the documented
stand-in used for codes whose published tables are not yet embedded
(currently FST4's LDPC(240,101) and JS8's LDPC(174,87)): same
rate/length/degree profile, hence the same waterfall region, but not
on-air compatible until the published table is dropped into
``Code.from_parity_matrix``.

Decoder
-------
Normalized min-sum BP with a fixed iteration count, fully batched over
candidates:

- messages live in a dense ``[batch, n_checks, max_row_weight]`` tensor
  (static shapes; padded lanes masked), gathered/scattered with ``jnp.take``
  — XLA turns these into batched device gathers;
- no data-dependent control flow: all batch elements run all iterations,
  convergence is detected afterwards by the parity/CRC mask (the decode
  batch is already throughput-bound, so early exit buys little).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# GF(2) linear algebra (host, NumPy)
# ---------------------------------------------------------------------------

def gf2_row_reduce(mat: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """Row-reduce over GF(2); returns (reduced matrix, pivot column list)."""
    m = mat.copy().astype(np.uint8)
    rows, cols = m.shape
    pivots: list[int] = []
    r = 0
    for c in range(cols):
        if r >= rows:
            break
        pivot_rows = np.nonzero(m[r:, c])[0]
        if pivot_rows.size == 0:
            continue
        pr = r + pivot_rows[0]
        if pr != r:
            m[[r, pr]] = m[[pr, r]]
        elim = np.nonzero(m[:, c])[0]
        for e in elim:
            if e != r:
                m[e] ^= m[r]
        pivots.append(c)
        r += 1
    return m, pivots


@dataclasses.dataclass(frozen=True)
class Code:
    """A binary LDPC code with a systematic encoder.

    Codewords are ``[info_bits(k) | parity_bits(n-k)]``.
    """

    n: int
    k: int
    h: np.ndarray           # [n-k, n] parity-check matrix (0/1)
    gen_parity: np.ndarray  # [k, n-k]: parity = info @ gen_parity mod 2

    @staticmethod
    def from_parity_matrix(h: np.ndarray) -> "Code":
        h = np.asarray(h, dtype=np.uint8)
        n_checks, n = h.shape
        k = n - n_checks
        # Need the last (n-k) columns to be invertible for systematic
        # encoding; callers should pre-arrange columns (make_ldpc_code does).
        b = h[:, k:]
        binv = gf2_invert(b)
        if binv is None:
            raise ValueError("parity section of H is singular; permute columns")
        # parity = (Binv @ A @ info) with A = H[:, :k]
        a = h[:, :k]
        gen = (binv @ a) % 2           # [n-k, k]
        return Code(n=n, k=k, h=h, gen_parity=gen.T.astype(np.uint8))

    def encode(self, info: np.ndarray) -> np.ndarray:
        info = np.asarray(info, dtype=np.uint8)
        parity = (info @ self.gen_parity) % 2
        return np.concatenate([info, parity.astype(np.uint8)], axis=-1)

    def syndrome(self, word: np.ndarray) -> np.ndarray:
        return (np.asarray(word, np.uint8) @ self.h.T) % 2


def gf2_invert(b: np.ndarray) -> np.ndarray | None:
    """Invert a square GF(2) matrix, or None if singular."""
    b = b.copy().astype(np.uint8)
    r = b.shape[0]
    aug = np.concatenate([b, np.eye(r, dtype=np.uint8)], axis=1)
    red, pivots = gf2_row_reduce(aug)
    if pivots[:r] != list(range(r)):
        return None
    return red[:, r:]


def make_ldpc_code(n: int, k: int, seed: int = 1, col_weight: int = 3) -> Code:
    """Deterministic pseudo-random regular-ish LDPC code with (n, k).

    Column weight 3 (the degree profile of the WSJT-X codes); row weights
    near-uniform.  Columns are permuted so the last n-k form an invertible
    square, giving a systematic encoder.  Deterministic in (n, k, seed).
    """
    n_checks = n - k
    rng = np.random.default_rng(seed)
    for attempt in range(64):
        h = np.zeros((n_checks, n), dtype=np.uint8)
        # distribute col_weight ones per column, balancing row weights
        row_fill = np.zeros(n_checks, dtype=np.int64)
        ok = True
        for c in rng.permutation(n):
            # choose the col_weight least-filled rows with random tie-break
            noise = rng.random(n_checks)
            order = np.lexsort((noise, row_fill))
            chosen = order[:col_weight]
            h[chosen, c] = 1
            row_fill[chosen] += 1
        # arrange columns: find an information set via row reduction
        red, pivots = gf2_row_reduce(h)
        if len(pivots) < n_checks:
            ok = False
        if ok:
            pivot_set = set(pivots)
            non_pivots = [c for c in range(n) if c not in pivot_set]
            perm = non_pivots + pivots  # info cols first, invertible block last
            hp = h[:, perm]
            try:
                code = Code.from_parity_matrix(hp)
                return code
            except ValueError:
                ok = False
        rng = np.random.default_rng(seed + 1000 + attempt)
    raise RuntimeError("failed to construct LDPC code")


# ---------------------------------------------------------------------------
# Dense message-passing tables (host-built, static)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BPTables:
    """Static index tables for the batched BP decoder."""

    n: int
    n_checks: int
    max_row: int              # max check degree
    row_cols: np.ndarray      # [n_checks, max_row] var index per check slot (pad n)
    row_mask: np.ndarray      # [n_checks, max_row] 1 for real slots
    max_col: int              # max variable degree
    col_slots: np.ndarray     # [n, max_col] flat index into [n_checks*max_row]
    col_mask: np.ndarray      # [n, max_col]


def build_bp_tables(h: np.ndarray) -> BPTables:
    h = np.asarray(h, np.uint8)
    n_checks, n = h.shape
    rows = [np.nonzero(h[i])[0] for i in range(n_checks)]
    max_row = max(len(r) for r in rows)
    row_cols = np.full((n_checks, max_row), n, dtype=np.int32)  # pad points at n
    row_mask = np.zeros((n_checks, max_row), dtype=np.float32)
    for i, r in enumerate(rows):
        row_cols[i, : len(r)] = r
        row_mask[i, : len(r)] = 1.0
    cols = [np.nonzero(h[:, j])[0] for j in range(n)]
    max_col = max(len(c) for c in cols)
    col_slots = np.zeros((n, max_col), dtype=np.int32)
    col_mask = np.zeros((n, max_col), dtype=np.float32)
    # flat slot index of (check i, var j) in the [n_checks, max_row] layout
    slot_of = {}
    for i, r in enumerate(rows):
        for s, j in enumerate(r):
            slot_of[(i, j)] = i * max_row + s
    for j, cs in enumerate(cols):
        for s, i in enumerate(cs):
            col_slots[j, s] = slot_of[(i, j)]
            col_mask[j, s] = 1.0
    return BPTables(n, n_checks, max_row, row_cols, row_mask,
                    max_col, col_slots, col_mask)


# ---------------------------------------------------------------------------
# Batched normalized min-sum decoder (device)
# ---------------------------------------------------------------------------

class BPDecoder:
    """Batched normalized min-sum BP for one code. Instances are cached per
    code; the jitted kernel re-traces only per (batch, iters) shape."""

    def __init__(self, code: Code, iters: int = 30, alpha: float = 0.8):
        self.code = code
        self.iters = iters
        self.alpha = alpha
        t = build_bp_tables(code.h)
        self.t = t
        # Keep tables as NumPy so constructing a decoder inside a jax trace
        # can never capture tracers (they become constants at use sites).
        self._row_cols = t.row_cols
        self._row_mask = t.row_mask
        self._col_slots = t.col_slots
        self._col_mask = t.col_mask
        self._h = code.h.astype(np.float32)

    def decode(self, llrs: jax.Array) -> tuple[jax.Array, jax.Array]:
        """llrs: [batch, n] (positive = bit 0 more likely).

        Returns (hard_bits [batch, n] int8, parity_ok [batch] bool).
        """
        hard, ok, _ = self.decode_full(llrs)
        return hard, ok

    @functools.partial(jax.jit, static_argnums=(0,))
    def decode_full(
        self, llrs: jax.Array
    ) -> tuple[jax.Array, jax.Array, jax.Array]:
        """Like :meth:`decode` but also returns the posterior LLR totals
        ``[batch, n]`` (channel LLR + all incoming check messages) — the
        soft input the OSD fallback pass reorders bits by."""
        b = llrs.shape[0]
        n, nc, mr = self.t.n, self.t.n_checks, self.t.max_row
        mc = self.t.max_col
        row_cols = jnp.asarray(self._row_cols)
        row_mask = jnp.asarray(self._row_mask)
        col_slots = jnp.asarray(self._col_slots)
        col_mask = jnp.asarray(self._col_mask)
        big = jnp.float32(1e9)

        def var_totals(m_cv):
            # var totals: channel LLR + sum of incoming check messages.
            # GATHER formulation (each var pulls its <=max_col incoming
            # slots) — a scatter-add here would serialize on conflicts.
            flat = m_cv.reshape(b, nc * mr)
            inc = jnp.take(flat, col_slots.reshape(-1), axis=1)
            inc = (inc.reshape(b, n, mc) * col_mask[None]).sum(-1)
            t = llrs + inc
            # pad a zero virtual variable at index n for padded row slots
            return jnp.concatenate([t, jnp.zeros((b, 1), t.dtype)], axis=1)

        # check->var messages, [b, nc, mr]
        m_cv = jnp.zeros((b, nc, mr), jnp.float32)

        def body(_, m_cv):
            totals = var_totals(m_cv)
            # var->check messages: total minus own incoming
            v_tot = jnp.take(totals, row_cols, axis=1)          # [b, nc, mr]
            m_vc = (v_tot - m_cv) * row_mask[None]
            # check update: normalized min-sum over other slots
            mag = jnp.abs(m_vc) + (1.0 - row_mask[None]) * big
            sgn = jnp.where(m_vc < 0, -1.0, 1.0) * row_mask[None] + (1.0 - row_mask[None])
            # product of signs over all slots / own sign
            tot_sgn = jnp.prod(sgn, axis=2, keepdims=True)
            # two smallest magnitudes
            m1 = jnp.min(mag, axis=2, keepdims=True)
            is_min = mag <= m1
            mag2 = jnp.where(is_min, big, mag)
            m2 = jnp.min(mag2, axis=2, keepdims=True)
            use = jnp.where(mag == m1, m2, m1)
            # handle duplicate minima: if slot value equals m1 but another slot
            # also attains m1, its "other min" is m1 itself
            n_min = jnp.sum(jnp.where(mag <= m1, 1.0, 0.0), axis=2, keepdims=True)
            use = jnp.where((mag == m1) & (n_min > 1), m1, use)
            new_cv = self.alpha * tot_sgn * sgn * use * row_mask[None]
            return new_cv

        m_cv = jax.lax.fori_loop(0, self.iters, body, m_cv)

        # final totals
        totals = var_totals(m_cv)
        hard = (totals[:, :n] < 0).astype(jnp.int8)   # LLR<0 -> bit 1
        syn = jnp.mod(
            jnp.dot(hard.astype(jnp.float32), self._h.T,
                    preferred_element_type=jnp.float32), 2.0
        )
        ok = jnp.all(syn < 0.5, axis=1)
        return hard, ok, totals[:, :n]


# ---------------------------------------------------------------------------
# Protocol codes (cached)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ft8_code() -> Code:
    """The published WSJT-X LDPC(174,91) code (FT8 & FT4): 77 payload + 14
    CRC info bits, 83 checks.  Built from the real parity table
    (modes/tables.py, lib/ft8/ldpc_174_91_c_parity.f90) so encoded frames
    and decoded codewords are bit-exact with jt9's — the capability the
    reference gets by spawning jt9 (source/DecoderPool.hpp:634-676)."""
    from cwsl_digi_tpu.modes import tables

    code = Code.from_parity_matrix(tables.ft8_parity_matrix())
    # Cross-check against the independently published generator hex rows.
    head = tables.generator_hex_rows(code.gen_parity)[: len(tables.FT8_GENERATOR_HEX_HEAD)]
    assert tuple(head) == tables.FT8_GENERATOR_HEX_HEAD, (
        "derived generator disagrees with published ldpc_174_91_c_generator"
    )
    return code


@functools.lru_cache(maxsize=None)
def fst4_code() -> Code:
    """LDPC(240,101): FST4/FST4W inner code.

    Uses the published WSJT-X ldpc_240_101 parity matrix when supplied via
    ``CWSL_DIGI_TPU_TABLES_DIR/fst4_ldpc_240_101.txt`` (modes/tables_ext.py;
    columns in codeword bit order, info bits first), else the documented
    same-profile stand-in."""
    from cwsl_digi_tpu.modes import tables_ext

    h = tables_ext.fst4_parity()
    if h is not None:
        return Code.from_parity_matrix(h)
    return make_ldpc_code(240, 101, seed=240)


@functools.lru_cache(maxsize=None)
def get_bp_decoder(which: str, iters: int = 30) -> BPDecoder:
    code = {"ft8": ft8_code, "fst4": fst4_code}[which]()
    return BPDecoder(code, iters=iters)
