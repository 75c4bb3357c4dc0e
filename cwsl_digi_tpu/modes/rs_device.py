"""Batched Reed-Solomon errors-and-erasures decoding ON DEVICE.

The reference outsources JT65's RS(63,12) to jt9 (spawn site
source/DecoderPool.hpp:648); a host trial loop (native/rs_ft.cpp) makes
the host the bottleneck at hundreds of q-ary channels, which the
reference never had (it burned cores in jt9.exe instead).

This module is the device replacement: ONE device program decodes
thousands of (sync candidate x erasure pattern) trials in parallel —
the Franke-Taylor-style stochastic erasure search is embarrassingly
data-parallel, it was only ever sequential because wsjt-x runs it on a
CPU.

Design notes:

- **GF(2^6) multiplication is carry-less multiply + reduction** over the
  primitive polynomial x^6+x+1 (0x43): 6 shift/select/XOR steps + 5
  reduction steps, pure elementwise work.  No log/exp table gathers:
  bitwise selects vectorize.
- **Everything is masked, nothing branches.**  Erasure counts vary per
  trial; the Berlekamp-Massey iteration space is the full 2t rounds with
  per-trial active masks (r > no_erasures), so one compiled program
  serves every pattern.
- **Validity = corrected-word syndromes all zero** — necessary and
  sufficient for codeword membership, so a masking bug in the Forney
  stage can only cause a miss, never a false decode.  Acceptance then
  applies the same soft re-encode score as the host path (qary_engine),
  computed on device from the stored top-4 tone energies.
- Per-step temporaries stay at [M, n]: syndromes/Chien/Omega accumulate
  over unrolled degree loops instead of materializing [M, 2t, n] cubes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PRIM_POLY = 0x43      # x^6 + x + 1
GF_M = 6
GF_Q = 64


def gmul(a, b):
    """Elementwise GF(64) multiply: carry-less mul + poly reduction."""
    a = a.astype(jnp.int32) if hasattr(a, "astype") else jnp.int32(a)
    b = b.astype(jnp.int32) if hasattr(b, "astype") else jnp.int32(b)
    r = jnp.zeros(jnp.broadcast_shapes(jnp.shape(a), jnp.shape(b)),
                  jnp.int32)
    for j in range(GF_M):
        r = r ^ jnp.where((b >> j) & 1 == 1, a << j, 0)
    for j in range(2 * GF_M - 2, GF_M - 1, -1):
        r = r ^ jnp.where((r >> j) & 1 == 1, PRIM_POLY << (j - GF_M), 0)
    return r


def ginv(a):
    """GF(64) inverse a^62 (square-and-multiply; inv(0) returns 0)."""
    # 62 = 0b111110
    a2 = gmul(a, a)            # a^2
    a3 = gmul(a2, a)           # a^3
    a6 = gmul(a3, a3)          # a^6
    a7 = gmul(a6, a)           # a^7
    a14 = gmul(a7, a7)         # a^14
    a15 = gmul(a14, a)         # a^15
    a30 = gmul(a15, a15)       # a^30
    a31 = gmul(a30, a)         # a^31
    return gmul(a31, a31)      # a^62


@functools.lru_cache(maxsize=None)
def _tables(n: int, nroots: int, fcr: int):
    """NumPy constant tables: alpha powers for syndromes and Chien."""
    exp = np.zeros(2 * GF_Q, np.int32)
    x = 1
    for i in range(GF_Q - 1):
        exp[i] = x
        x <<= 1
        if x & GF_Q:
            x ^= PRIM_POLY
    for i in range(GF_Q - 1, 2 * GF_Q):
        exp[i] = exp[i - (GF_Q - 1)]

    def apow(e: int) -> int:
        return int(exp[e % (GF_Q - 1)])

    # Position index i carries the x^(n-1-i) coefficient (rs64.py layout:
    # word[0] is the HIGHEST degree — systematic info rides the top powers)
    deg = [n - 1 - i for i in range(n)]
    # syndrome matrix: S_j = sum_i r_i alpha^{deg_i (fcr+j)}
    syn = np.zeros((nroots, n), np.int32)
    for j in range(nroots):
        for i in range(n):
            syn[j, i] = apow(deg[i] * (fcr + j))
    # position powers: X_i = alpha^{deg_i}; inverses for Chien/Forney
    xi = np.asarray([apow(d) for d in deg], np.int32)
    xi_inv = np.asarray([apow(-d % (GF_Q - 1)) for d in deg], np.int32)
    # Chien: CH[d, i] = (X_i^{-1})^d, d = 0..nroots (locator degree)
    ch = np.zeros((nroots + 1, n), np.int32)
    for dd in range(nroots + 1):
        for i in range(n):
            ch[dd, i] = apow((-deg[i] * dd) % (GF_Q - 1))
    # X_i^{1-fcr} factor for Forney
    xfcr = np.asarray([apow((d * (1 - fcr)) % (GF_Q - 1)) for d in deg],
                      np.int32)
    return syn, xi, xi_inv, ch, xfcr


def _xor_reduce(x, axis):
    return jax.lax.reduce(x, np.int32(0), jax.lax.bitwise_xor, (axis,))


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def rs_ee_decode(nk_fcr: tuple, shapes: tuple, _unused, recv, era):
    """Batched errors-and-erasures RS decode.

    nk_fcr = (n, k, fcr); recv [M, n] int32 received symbols;
    era [M, n] bool erasure flags.  Returns (corrected [M, n], ok [M]).
    ok = corrected word has all-zero syndromes AND differs from recv only
    at erased or located-error positions (membership is the real gate).
    """
    n, k, fcr = nk_fcr
    nroots = n - k
    syn_np, xi, xi_inv, ch, xfcr = _tables(n, nroots, fcr)
    syn_t = jnp.asarray(syn_np)
    xi_d = jnp.asarray(xi)
    ch_d = jnp.asarray(ch)
    m = recv.shape[0]

    def syndromes(word):
        def body(i, s):
            col = jax.lax.dynamic_slice(word, (0, i), (m, 1))
            return s ^ gmul(col, jnp.take(syn_t, i, axis=1)[None, :])
        return jax.lax.fori_loop(
            0, n, body, jnp.zeros((m, nroots), jnp.int32))

    s = syndromes(recv)

    # --- erasure locator Gamma(x) = prod_{era} (1 + X_l x) -------------
    def gamma_body(i, lam):
        shifted = jnp.concatenate(
            [jnp.zeros((m, 1), jnp.int32),
             gmul(lam[:, :-1], jnp.take(xi_d, i))], axis=1)
        flag = jax.lax.dynamic_slice(era, (0, i), (m, 1))
        return jnp.where(flag, lam ^ shifted, lam)

    lam0 = jnp.zeros((m, nroots + 1), jnp.int32).at[:, 0].set(1)
    lam = jax.lax.fori_loop(0, n, gamma_body, lam0)
    no_eras = jnp.sum(era.astype(jnp.int32), axis=1)        # [M]

    # --- Berlekamp-Massey with erasures (Karn decode_rs recursion) ------
    lam_len = nroots + 1
    s_pad = jnp.concatenate([jnp.zeros((m, lam_len), jnp.int32), s],
                            axis=1)

    def bm_body(r, carry):
        lam, b, el = carry
        active = r > no_eras                                 # [M]
        # discrepancy = sum_i lam[i] * S[r-1-i]
        sl = jax.lax.dynamic_slice(s_pad, (0, r), (m, lam_len))
        d = _xor_reduce(gmul(lam[:, ::-1], sl), 1)           # [M]
        d_nz = (d != 0) & active
        b_shift = jnp.concatenate(
            [jnp.zeros((m, 1), jnp.int32), b[:, :-1]], axis=1)
        t = lam ^ gmul(d[:, None], b_shift)
        deg_cond = d_nz & (2 * el <= (r - 1) + no_eras)
        b_new = jnp.where(deg_cond[:, None],
                          gmul(lam, ginv(d)[:, None]), b_shift)
        el = jnp.where(deg_cond, r + no_eras - el, el)
        lam = jnp.where(active[:, None], t, lam)
        b = jnp.where(active[:, None], b_new, b)
        return lam, b, el

    lam, _, el = jax.lax.fori_loop(1, nroots + 1, bm_body,
                                   (lam, lam, no_eras))

    # --- Chien search + Omega + Forney, one degree-indexed loop each ----
    def chien_body(d, ev):
        col = jax.lax.dynamic_slice(lam, (0, d), (m, 1))
        return ev ^ gmul(col, jnp.take(ch_d, d, axis=0)[None, :])

    ev = jax.lax.fori_loop(0, nroots + 1, chien_body,
                           jnp.zeros((m, n), jnp.int32))
    is_err = ev == 0                                         # [M, n]

    # Omega = S * Lambda mod x^nroots: omega_j ^= lam_d * S_{j-d}
    s_lpad = jnp.concatenate([jnp.zeros((m, nroots), jnp.int32), s],
                             axis=1)

    def omega_body(d, om):
        col = jax.lax.dynamic_slice(lam, (0, d), (m, 1))
        s_shift = jax.lax.dynamic_slice(s_lpad, (0, nroots - d), (m, nroots))
        return om ^ gmul(col, s_shift)

    omega = jax.lax.fori_loop(0, nroots + 1, omega_body,
                              jnp.zeros((m, nroots), jnp.int32))

    # Omega(X_i^{-1}) and Lambda'(X_i^{-1}); derivative keeps odd degrees
    def omev_body(d, acc):
        col = jax.lax.dynamic_slice(omega, (0, d), (m, 1))
        return acc ^ gmul(col, jnp.take(ch_d, d, axis=0)[None, :])

    om_ev = jax.lax.fori_loop(0, nroots, omev_body,
                              jnp.zeros((m, n), jnp.int32))

    def dlam_body(j, acc):
        d = 2 * j + 1
        col = jax.lax.dynamic_slice(lam, (0, d), (m, 1))
        return acc ^ gmul(col, jnp.take(ch_d, d - 1, axis=0)[None, :])

    dlam_ev = jax.lax.fori_loop(0, (nroots + 1) // 2, dlam_body,
                                jnp.zeros((m, n), jnp.int32))
    mag = gmul(gmul(om_ev, ginv(dlam_ev)), jnp.asarray(xfcr)[None, :])
    corrected = recv ^ jnp.where(is_err, mag, 0)

    # --- membership check: corrected syndromes must vanish --------------
    ok = jnp.all(syndromes(corrected) == 0, axis=1)
    return corrected, ok


# deterministic erasure tiers (match the host ERASURE_SCHEDULE) + the
# stochastic Chase tiers' target erasure depths
DET_TIERS = (0, 8, 16, 24, 32, 40)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def rs_chase_program(nk_fcr: tuple, n_trials: int, n_det: int,
                     accept: float, syms, margin, top_e, top_tone, e_sum,
                     seed):
    """Chase trial fan-out + decode + soft accept for a candidate batch.

    syms [C, n] int32 (codeword-domain), margin [C, n] f32 (per-symbol
    confidence), top_e [C, n, 4] / top_tone [C, n, 4] / e_sum [C, n] from
    the demod stage.  Returns (info [C, k], score [C], ok [C]): the best
    accepted trial per candidate.
    """
    n, k, fcr = nk_fcr
    nroots = n - k
    c = syms.shape[0]
    # confidence rank per symbol (0 = least confident)
    order = jnp.argsort(margin, axis=1)
    rank = jnp.zeros((c, n), jnp.int32).at[
        jnp.arange(c)[:, None], order].set(jnp.arange(n, dtype=jnp.int32))

    # erasure patterns: det tiers erase the f least-confident symbols,
    # stochastic tiers draw biased random patterns at increasing depth
    tiers = list(DET_TIERS[:n_det])
    det = jnp.stack([rank < f for f in tiers], axis=1)       # [C, D, n]
    n_sto = n_trials - det.shape[1]
    key = jax.random.fold_in(jax.random.PRNGKey(17), seed)
    u = jax.random.uniform(key, (c, n_sto, n))
    # erasure probability decreasing with confidence rank; depth ramps
    # from ~nroots-11 to ~nroots-2 expected erasures across trials
    depth = jnp.linspace(nroots - 14.0, nroots - 2.0, n_sto)
    p = (0.9 - 0.8 * rank.astype(jnp.float32) / (n - 1))[:, None, :]
    p = p * (depth[None, :, None] / jnp.sum(p, axis=2, keepdims=True))
    sto = u < p
    era = jnp.concatenate([det, sto], axis=1)                # [C, T, n]

    recv = jnp.broadcast_to(syms[:, None, :], (c, n_trials, n))
    m = c * n_trials
    corrected, ok = rs_ee_decode(nk_fcr, (), None,
                                 recv.reshape(m, n),
                                 era.reshape(m, n))
    corrected = corrected.reshape(c, n_trials, n)
    ok = ok.reshape(c, n_trials)

    # soft re-encode score (qary_engine._soft_score, vectorized): mean
    # log(E[cw tone] / mean symbol energy), top-4 else residual floor
    hit = corrected[:, :, :, None] == top_tone[:, None, :, :]  # [C,T,n,4]
    e_top = jnp.sum(jnp.where(hit, top_e[:, None], 0.0), axis=-1)
    floor = (e_sum - jnp.sum(top_e, axis=-1)) / (GF_Q - 4)
    e_cw = jnp.where(hit.any(axis=-1), e_top, floor[:, None, :])
    mean_e = (e_sum / n)[:, None, :]
    logr = jnp.log((e_cw + 1e-30) / (mean_e + 1e-30))          # [C, T, n]
    score = jnp.mean(logr, axis=-1)
    # Erased positions are the INDEPENDENT verification: the RS decoder
    # never saw them, so for a true codeword they still carry signal
    # energy while a noise-forced codeword scores ~0 there.  Deep-erasure
    # trials (f up to n-k-2) can force ANY word into the code, so without
    # this gate a 256-trial fan-out false-decodes on pure noise
    # (measured 2/12 windows before the gate, 0 after).
    n_era = jnp.sum(era, axis=-1).astype(jnp.float32)          # [C, T]
    s_era = (jnp.sum(logr * era, axis=-1)
             / jnp.maximum(n_era, 1.0))
    ok = ok & ((n_era < 8) | (s_era >= 0.6 * accept))
    score = jnp.where(ok, score, -jnp.inf)

    best = jnp.argmax(score, axis=1)                         # [C]
    bidx = jnp.arange(c)
    best_score = score[bidx, best]
    info = corrected[bidx, best, :k]
    # the all-zero word is a codeword of every RS code and wins on dead
    # air; require real content (gfsk_engine's nonzero_payload analogue)
    best_ok = (ok[bidx, best] & (best_score >= accept)
               & jnp.any(info != 0, axis=1))
    return info, best_score, best_ok
