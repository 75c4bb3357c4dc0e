"""WSPR: 4-FSK beacon mode, 120 s T/R, K=32 r=1/2 convolutional code.

The reference spawns ``wsprd -C <cycles> -o 5 -d`` per window
(source/DecoderPool.hpp:1023-1026, cycles knob config.ini:217-222) and
parses its 8-field output (source/OutputHandler.cpp:314-401).  Here WSPR is
native:

Physical layer (public WSPR parameters):
  - 162 symbols x 8192 samples @ 12 kHz (0.683 s/symbol, 1.4648 baud);
  - 4-FSK, tone spacing = baud; ``tone = sync_bit + 2*data_bit`` — the LSB
    carries a fixed 162-chip pseudo-random sync vector, the MSB the data;
  - 50 message bits (28-bit callsign + 15-bit grid + 7-bit power) + 31 zero
    tail bits, convolutionally encoded at rate 1/2 with the K=32
    Layland-Lushbaugh polynomials 0xF2D05351 / 0xE4613C47 -> 162 bits,
    interleaved by 8-bit bit-reversal of the position index;
  - transmission starts ~1 s into the even 2-minute slot, 110.6 s long,
    centered near 1500 Hz audio.

Batched device decoder:
  1. spectrogram (8192-sample frames, 2048 hop, 16384-pt rfft -> half-tone
     bins) restricted to the 200 Hz WSPR subband;
  2. sync-vector correlation over (t0, f0) as 162 signed shifted-slice adds
     of a precomputed per-hop sync-contrast map;
  3. top-K candidates; per-symbol data LLRs from the sync-conditioned tone
     pair; deinterleave (static permutation);
  4. **beam-search sequential decoder** (lax.scan, fixed beam width) — the
     parallelizable substitute for wsprd's Fano search (SURVEY.md §7 "hard
     parts"): all beams advance in lockstep, tail bits forced to zero; the
     ``cycles`` effort knob of wsprd maps to beam width here;
  5. validation by re-encoding the winning path and checking weighted
     agreement with the received LLRs (WSPR has no CRC).

The 162-chip sync vector is the published WSPR sequence (wsprd.c ``pr3``,
``tables.WSPR_SYNC``), so sync acquisition is protocol-exact for on-air
signals.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from cwsl_digi_tpu.constants import Mode, WAVE_SR
from cwsl_digi_tpu.modes.base import DecodeResult
from cwsl_digi_tpu.modes.gfsk import gfsk_modulate

# ---------------------------------------------------------------------------
# Protocol constants
# ---------------------------------------------------------------------------
NSYM = 162
SPS = 8192
BAUD = WAVE_SR / SPS               # 1.46484375
TONE_SPACING = BAUD
T_R = 120.0
SIGNAL_START_S = 1.0
N_MSG_BITS = 50
N_TAIL = 31
POLY1 = 0xF2D05351
POLY2 = 0xE4613C47

HOP = SPS // 4                     # 2048
NFFT = 2 * SPS                     # 16384 -> 0.7324 Hz bins
BIN_HZ = WAVE_SR / NFFT
FMIN_HZ, FMAX_HZ = 1400.0, 1600.0
PAD_HOPS = 32


from cwsl_digi_tpu.modes.tables import WSPR_SYNC  # noqa: E402

SYNC = np.asarray(WSPR_SYNC, np.int32)
assert SYNC.shape == (NSYM,)


def interleave_map(n: int = NSYM) -> np.ndarray:
    """dest[i] = bit-reversed-index order (wsprd's interleaver)."""
    out = []
    for i in range(256):
        j = int(f"{i:08b}"[::-1], 2)
        if j < n:
            out.append(j)
        if len(out) == n:
            break
    return np.asarray(out, np.int32)     # position of source bit k -> out[k]


INTERLEAVE = interleave_map()


# ---------------------------------------------------------------------------
# Convolutional code (host reference + device tables)
# ---------------------------------------------------------------------------

def _parity32(x: int) -> int:
    return bin(x & 0xFFFFFFFF).count("1") & 1


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """K=32 r=1/2 encoder over bits+tail -> 162 coded bits (pre-interleave)."""
    bits = np.asarray(bits, np.uint8)
    assert bits.shape == (N_MSG_BITS,)
    reg = 0
    out = []
    for b in np.concatenate([bits, np.zeros(N_TAIL, np.uint8)]):
        reg = ((reg << 1) | int(b)) & 0xFFFFFFFF
        out.append(_parity32(reg & POLY1))
        out.append(_parity32(reg & POLY2))
    return np.asarray(out, np.uint8)


@functools.lru_cache(maxsize=None)
def _code_matrices() -> tuple[np.ndarray, np.ndarray]:
    """(G [50,162], R [162,50]) over GF(2) with G @ R = I.

    The conv encoder (zero tail) is linear, so the transmitted 162 coded
    bits form a (162, 50) linear block code: G rows = encodings of unit
    messages, in coded-bit (pre-interleave) order — the order the decode
    program's deinterleaved LLRs use.  R is a right-inverse recovering the
    message from any codeword (``bits = cw @ R mod 2``), built from the row
    ops of a GF(2) elimination.  This is what makes ``wsprd -o`` style
    ordered-statistics decoding (source/DecoderPool.hpp:1023-1026 spawns
    ``wsprd ... -o 5``) applicable to the sequential code.
    """
    eye = np.eye(N_MSG_BITS, dtype=np.uint8)
    G = np.stack([conv_encode(eye[i]) for i in range(N_MSG_BITS)])
    A = G.copy()
    E = np.eye(N_MSG_BITS, dtype=np.uint8)
    r = 0
    pivots = []
    for c in range(A.shape[1]):
        nz = np.nonzero(A[r:, c])[0]
        if len(nz) == 0:
            continue
        p = r + nz[0]
        A[[r, p]] = A[[p, r]]
        E[[r, p]] = E[[p, r]]
        for i in np.nonzero(A[:, c])[0]:
            if i != r:
                A[i] ^= A[r]
                E[i] ^= E[r]
        pivots.append(c)
        r += 1
        if r == N_MSG_BITS:
            break
    assert r == N_MSG_BITS, "generator matrix not full rank"
    # G[:, pivots] = E^-1, so R[pivots, :] = E gives G @ R = I
    R = np.zeros((NSYM, N_MSG_BITS), np.uint8)
    R[np.asarray(pivots)] = E
    assert np.array_equal(G.dot(R) % 2, np.eye(N_MSG_BITS, dtype=np.uint8))
    return G, R


# ---------------------------------------------------------------------------
# Message packing (callsign + grid + power, 50 bits) — the call/grid charsets
# are the protocol tables shared with the FT8 codec (message77.py)
# ---------------------------------------------------------------------------
from cwsl_digi_tpu.modes import legacy72  # noqa: E402


def pack_message(callsign: str, grid: str, dbm: int) -> np.ndarray:
    """Type-1 WSPR payload: [packcall:28][grid15:15][pwr+64:7].

    Bit-exact per G4JNT "The WSPR Coding Process": N1 = packcall,
    M1 = (179-10*lonA-lonD)*180 + 10*latA + latD, N2 = M1*128 + pwr + 64.
    """
    n = legacy72.packcall(callsign)
    if n is None or n >= legacy72.NBASE:
        raise ValueError(f"cannot pack WSPR callsign {callsign!r}")
    m = legacy72.packgrid15(grid)
    if m is None:
        raise ValueError(f"bad grid {grid!r}")
    p = max(0, min(60, int(dbm))) + 64
    bits = (
        [(n >> (27 - i)) & 1 for i in range(28)]
        + [(m >> (14 - i)) & 1 for i in range(15)]
        + [(p >> (6 - i)) & 1 for i in range(7)]
    )
    return np.asarray(bits, np.uint8)


def unpack_message(bits: np.ndarray) -> tuple[str, str, int]:
    bits = np.asarray(bits, np.uint8)
    n = 0
    for b in bits[:28]:
        n = (n << 1) | int(b)
    call = legacy72.unpackcall(n)
    if call is None or n >= legacy72.NBASE:
        raise ValueError("invalid callsign field")
    m = 0
    for b in bits[28:43]:
        m = (m << 1) | int(b)
    grid = legacy72.unpackgrid15(m)
    if grid is None:
        raise ValueError("invalid grid field")
    p = 0
    for b in bits[43:50]:
        p = (p << 1) | int(b)
    ntype = p - 64
    if not 0 <= ntype <= 60:
        raise ValueError("invalid power field (non-type-1 message)")
    return call, grid, ntype


def encode(callsign: str, grid: str, dbm: int) -> np.ndarray:
    """Message -> 162 tone indices."""
    coded = conv_encode(pack_message(callsign, grid, dbm))
    interleaved = np.zeros(NSYM, np.uint8)
    interleaved[INTERLEAVE] = coded
    return (SYNC + 2 * interleaved.astype(np.int32)).astype(np.int32)


def synthesize(callsign: str, grid: str, dbm: int, f0_hz: float = 1500.0,
               amplitude: float = 1.0,
               window_len: int = int(T_R * WAVE_SR),
               start_s: float = SIGNAL_START_S) -> np.ndarray:
    tones = encode(callsign, grid, dbm)
    burst = gfsk_modulate(tones, f0_hz, SPS, WAVE_SR, TONE_SPACING, bt=2.0)
    out = np.zeros(window_len)
    start = int(round(start_s * WAVE_SR))
    n = min(len(burst), window_len - start)
    out[start : start + n] = amplitude * burst[:n]
    return out


# ---------------------------------------------------------------------------
# Device decode program
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WSPRConfig:
    top_k: int = 24
    beam_width: int = 512       # wsprd `cycles` effort analogue
    max_hops: int = 48          # start-time search grid (x 0.17 s)
    # linear drift hypotheses over the burst, Hz end-to-end (wsprd searches
    # +-4 Hz; source invocation DecoderPool.hpp:1023-1026)
    drifts_hz: tuple[float, ...] = (-4.0, -2.0, 0.0, 2.0, 4.0)
    # OSD fallback over the (162, 50) block code (wsprd's -o flag analogue;
    # spawn site source/DecoderPool.hpp:1023-1026); 0 disables
    osd_j: int = 8              # strongest sync candidates to try
    osd_singles: int = 50
    osd_tail2: int = 26
    osd_tail3: int = 14
    # decision-directed coherent refinement: re-encode the best path, fix
    # every neighbor's tone, re-demod each symbol with a +-dd_window
    # coherent sum, decode again.  THE effort lever wsprcycles maps to —
    # beam width / OSD depth / top_k were all measured inert at -31 dB
    # (the LLRs, not the search, are the wall).
    dd_passes: int = 2
    dd_window: int = 4


def _drift_offsets(cfg: WSPRConfig) -> np.ndarray:
    """[D, NSYM] per-symbol bin offsets for each linear drift hypothesis."""
    d = np.asarray(cfg.drifts_hz)[:, None]          # Hz end-to-end
    frac = (np.arange(NSYM)[None, :] / (NSYM - 1)) - 0.5
    return np.round(d * frac / BIN_HZ).astype(np.int32)


def _popcount32(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


@functools.partial(jax.jit, static_argnums=(0, 1))
def _decode_program(cfg: WSPRConfig, shapes, audio, sync, deinter, window):
    (n_samples,) = shapes
    b = audio.shape[0]
    n_hops = (n_samples - SPS) // HOP + 1
    fmin_bin = int(FMIN_HZ / BIN_HZ)
    fmax_bin = int(FMAX_HZ / BIN_HZ)
    n_bins = fmax_bin - fmin_bin + 8

    # two windows: tapered for the sync search, boxcar (matched filter for
    # constant tones) for the data demod — see gfsk_engine.decode_program.
    # The boxcar spectrogram stays COMPLEX: the demod combines adjacent
    # symbols coherently (GFSK phase continuity), which needs cross terms.
    idx = jnp.arange(n_hops)[:, None] * HOP + jnp.arange(SPS)[None, :]
    frames = audio[:, idx]

    def spectrogram(w, keep_complex=False):
        x = jnp.fft.rfft(frames * w[None, None, :], n=NFFT, axis=-1)
        x = x[:, :, fmin_bin : fmin_bin + n_bins]
        x = jnp.pad(x, ((0, 0), (PAD_HOPS, PAD_HOPS), (0, 0)))
        return x if keep_complex else jnp.abs(x) ** 2

    power_sync = spectrogram(window)
    stft = spectrogram(jnp.ones((SPS,), jnp.float32), keep_complex=True)
    power = jnp.abs(stft) ** 2

    # sync-contrast map: m[h, f] = P(tone1)+P(tone3) - P(tone0)-P(tone2)
    n_f0 = fmax_bin - fmin_bin
    p = power_sync
    mmap = (
        jax.lax.slice(p, (0, 0, 2), (b, p.shape[1], 2 + n_f0))
        + jax.lax.slice(p, (0, 0, 6), (b, p.shape[1], 6 + n_f0))
        - jax.lax.slice(p, (0, 0, 0), (b, p.shape[1], n_f0))
        - jax.lax.slice(p, (0, 0, 4), (b, p.shape[1], 4 + n_f0))
    )

    n_t0 = cfg.max_hops
    sync_np = SYNC  # static sync vector for trace-time branching
    offs = _drift_offsets(cfg)                   # [D, NSYM] static
    n_d = offs.shape[0]
    # headroom so drift-shifted slices stay in range
    max_off = int(np.abs(offs).max())
    scores = []
    for di in range(n_d):
        acc = jnp.zeros((b, n_t0, n_f0 - 2 * max_off), jnp.float32)
        for i in range(NSYM):
            h0 = 4 * i
            b0 = max_off + int(offs[di, i])
            sl = jax.lax.slice(mmap, (0, h0, b0),
                               (b, h0 + n_t0, b0 + n_f0 - 2 * max_off))
            acc = acc + (sl if sync_np[i] > 0 else -sl)
        scores.append(acc)
    score_d = jnp.stack(scores, axis=1)          # [B, D, n_t0, n_f0']
    base = jnp.mean(power, axis=(1, 2), keepdims=True) * NSYM
    score_d = score_d / (base[:, :, :, None] + 1e-30)

    n_f0p = n_f0 - 2 * max_off
    flat = score_d.reshape(b, -1)
    top_val, top_idx = jax.lax.top_k(flat, cfg.top_k)
    d_idx = top_idx // (n_t0 * n_f0p)
    rem = top_idx % (n_t0 * n_f0p)
    t0 = rem // n_f0p
    f0 = rem % n_f0p + max_off                   # back to mmap bin coords

    # per-symbol data LLRs: bit=0 -> tone sync_i, bit=1 -> tone sync_i+2;
    # bins follow the candidate's drift trajectory.  Coherent 1/2/3-symbol
    # demod (the gfsk_engine._multisym_llrs scheme, specialized): every WSPR
    # symbol has a KNOWN sync chip in the tone LSB, so each neighbor
    # hypothesis cube is only 2 wide (data bit), and tone spacing = baud
    # makes the inter-symbol reference rotation tone-independent:
    # rot = exp(-2j*pi*abs_bin*SPS/NFFT).
    offs_j = jnp.asarray(offs)                   # [D, NSYM]
    cand_off = offs_j[d_idx]                     # [B, K, NSYM]
    sym_hops = t0[:, :, None] + 4 * jnp.arange(NSYM, dtype=jnp.int32)[None, None, :]
    # allowed tone per (symbol, data bit): sync_i + 2*bit -> bin 2*tone
    tone_bins = (2 * sync[None, None, :, None]
                 + 4 * jnp.arange(2, dtype=jnp.int32)[None, None, None, :])
    bins = f0[:, :, None, None] + cand_off[:, :, :, None] + tone_bins
    bb = jnp.arange(b)[:, None, None, None]
    cbit = stft[bb, sym_hops[:, :, :, None], bins]            # [B,K,162,2] c64
    abs_bin = (f0 + fmin_bin).astype(jnp.float32)
    rot = jnp.exp(-2j * jnp.pi * abs_bin * (SPS / NFFT))      # [B, K]
    e1 = jnp.abs(cbit) ** 2                                   # [B,K,162,2]
    # Sub-bin frequency-residual correction (the gfsk_engine refine_freq
    # analogue): a +-BIN/2 residual rotates up to 1.6 rad PER SYMBOL at
    # WSPR's 0.68 s symbols, zeroing the coherent pair/triple terms for
    # off-bin signals.  WSPR has no all-known sync symbols, so estimate
    # from hard-decision pairs: at threshold ~75% of per-symbol hard bits
    # are right, and wrong-bit pair products contribute noise, not bias
    # (tone spacing = baud makes the DFT phase tone-independent).
    hard = jnp.argmax(e1, axis=-1)                            # [B,K,162]
    cb = jnp.take_along_axis(cbit, hard[..., None], axis=-1)[..., 0]
    z = jnp.sum(jnp.conj(cb[:, :, :-1]) * cb[:, :, 1:], axis=-1) * rot
    rot = rot * jnp.exp(-1j * jnp.angle(z))
    r_ = rot[:, :, None, None, None]

    cpad = jnp.pad(cbit, ((0, 0), (0, 0), (1, 1), (0, 0)))
    cprev = cpad[:, :, :NSYM]                                 # symbol s-1
    cnext = cpad[:, :, 2:]                                    # symbol s+1
    e1p = jnp.abs(cprev) ** 2
    e1n = jnp.abs(cnext) ** 2
    # cross terms [B,K,162,i,j]: i = neighbor bit, j = self bit
    x_ps = 2.0 * jnp.real(jnp.conj(cprev)[..., :, None]
                          * (r_ * cbit[..., None, :]))
    x_sn = 2.0 * jnp.real(jnp.conj(cbit)[..., :, None]
                          * (r_ * cnext[..., None, :])).swapaxes(-1, -2)
    # pair metrics, max-marginalized over the neighbor's data bit
    e2p = e1 + jnp.max(e1p[..., :, None] + x_ps, axis=-2)
    e2n = e1 + jnp.max(e1n[..., :, None] + x_sn, axis=-2)
    # triple metric [B,K,162,p,j,n] -> max over (prev, next) bits
    x_pn = 2.0 * jnp.real(jnp.conj(cprev)[..., :, None]
                          * (r_ * r_ * cnext[..., None, :]))
    tri = (e1p[..., :, None, None] + e1[..., None, :, None]
           + e1n[..., None, None, :]
           + x_ps[..., :, :, None]
           + x_sn.swapaxes(-1, -2)[..., None, :, :]
           + x_pn[..., :, None, :])
    e3 = jnp.max(tri, axis=(-3, -1))                          # [B,K,162,2]
    # 4-symbol coherent windows (gfsk_engine coh4, specialized): the WSPR
    # neighbor hypothesis is one data BIT, so each window maxes over only
    # 2^3 = 8 combos — long coherence nearly free, and WSPR's last dBs
    # live exactly here (wsprcycles' sensitivity lever, re-based below)
    cprev2 = jnp.pad(cbit, ((0, 0), (0, 0), (2, 2), (0, 0)))[:, :, :NSYM]
    cnext2 = jnp.pad(cbit, ((0, 0), (0, 0), (2, 2), (0, 0)))[:, :, 4:]
    e1p2 = jnp.abs(cprev2) ** 2
    e1n2 = jnp.abs(cnext2) ** 2
    r2_ = r_ * r_
    r3_ = r2_ * r_

    def xterm(a, bb2, rr):                 # 2Re(conj(a) rr b): [..., i, j]
        return 2.0 * jnp.real(jnp.conj(a)[..., :, None]
                              * (rr * bb2[..., None, :]))

    x_p_nn = xterm(cprev, cnext2, r3_)
    x_s_nn = xterm(cbit, cnext2, r2_)
    x_n_nn = xterm(cnext, cnext2, r_)
    x_pp_p = xterm(cprev2, cprev, r_)
    x_pp_s = xterm(cprev2, cbit, r2_)
    x_pp_n = xterm(cprev2, cnext, r3_)
    # window [s-1, s, s+1, s+2]: axes (..., p, self, n, q)
    w4n = (e1p[..., :, None, None, None] + e1[..., None, :, None, None]
           + e1n[..., None, None, :, None] + e1n2[..., None, None, None, :]
           + x_ps[..., :, :, None, None]
           + x_pn[..., :, None, :, None]
           + x_p_nn[..., :, None, None, :]
           + x_sn.swapaxes(-1, -2)[..., None, :, :, None]
           + x_s_nn[..., None, :, None, :]
           + x_n_nn[..., None, None, :, :])
    e4n = jnp.max(w4n, axis=(-4, -2, -1))                     # [B,K,162,2]
    # window [s-2, s-1, s, s+1]: axes (..., q2, p, self, n)
    w4p = (e1p2[..., :, None, None, None] + e1p[..., None, :, None, None]
           + e1[..., None, None, :, None] + e1n[..., None, None, None, :]
           + x_pp_p[..., :, :, None, None]
           + x_pp_s[..., :, None, :, None]
           + x_pp_n[..., :, None, None, :]
           + x_ps[..., None, :, :, None]
           + x_pn[..., None, :, None, :]
           + x_sn.swapaxes(-1, -2)[..., None, None, :, :])
    e4p = jnp.max(w4p, axis=(-4, -3, -1))                     # [B,K,162,2]
    metric_sym = e1 + e2p + e2n + e3 + e4n + e4p
    llr_sym = metric_sym[..., 0] - metric_sym[..., 1]         # [B, K, 162]
    # per-candidate scale normalization (energies are scale-dependent)
    llr_sym = llr_sym / (jnp.std(llr_sym, axis=-1, keepdims=True) + 1e-20) * 3.0
    llr = jnp.take(llr_sym, deinter, axis=2)                 # coded-bit order
    # interleaved pairs: coded bit 2t, 2t+1 for trellis step t
    llr = llr.reshape(b * cfg.top_k, 81, 2)

    bits, metric = _beam_decode(cfg, llr)

    # --- decision-directed coherent refinement passes --------------------
    # With a full candidate word in hand every one of the 162 tones is
    # hypothesized known, so each symbol can be re-demodulated as a
    # +-dd_window COHERENT sum with its neighbors fixed (a DFE over the
    # stationary-phase frame v_s = C_s * rot^s) — far stronger than the
    # hypothesis-maxed 2/3/4-symbol metrics when the first decode was
    # mostly right.  Wrong first decodes refine into garbage and lose the
    # path-metric comparison, so the best pass wins per candidate.
    if cfg.dd_passes > 1:
        g_mat, _ = _code_matrices()
        g_dev = jnp.asarray(g_mat, jnp.float32)               # [50, 162]
        inter_inv = np.empty(NSYM, np.int64)
        inter_inv[INTERLEAVE] = np.arange(NSYM)
        inter_inv = jnp.asarray(inter_inv)
        phi = jnp.angle(rot)                                  # [B, K]
        rot_pow = jnp.exp(
            1j * phi[:, :, None] * jnp.arange(NSYM)[None, None, :])
        v = cbit * rot_pow[..., None]                         # [B,K,162,2]
        v_flat = v.reshape(b * cfg.top_k, NSYM, 2)
        w_dd = cfg.dd_window
        for _pass in range(cfg.dd_passes - 1):
            coded = jnp.mod(bits.astype(jnp.float32) @ g_dev, 2.0)
            d_sym = jnp.take(coded, inter_inv, axis=1).astype(jnp.int32)
            chosen = jnp.take_along_axis(
                v_flat, d_sym[:, :, None], axis=-1)[..., 0]   # [N, 162]
            csum = jnp.cumsum(
                jnp.pad(chosen, ((0, 0), (1, 0))), axis=1)    # prefix sums
            lo = np.maximum(np.arange(NSYM) - w_dd, 0)
            hi = np.minimum(np.arange(NSYM) + w_dd + 1, NSYM)
            s_win = csum[:, hi] - csum[:, lo]                 # [N, 162]
            s_excl = s_win - chosen
            e_dd = jnp.abs(s_excl[:, :, None] + v_flat) ** 2  # [N,162,2]
            llr_dd = e_dd[..., 0] - e_dd[..., 1]
            llr_dd = llr_dd / (jnp.std(llr_dd, axis=-1, keepdims=True)
                               + 1e-20) * 3.0
            llr_dd = jnp.take(llr_dd, deinter, axis=1).reshape(
                b * cfg.top_k, 81, 2)
            bits2, metric2 = _beam_decode(cfg, llr_dd)
            better = metric2 > metric
            bits = jnp.where(better[:, None], bits2, bits)
            metric = jnp.maximum(metric2, metric)

    bits = bits.reshape(b, cfg.top_k, N_MSG_BITS)
    metric = metric.reshape(b, cfg.top_k)

    # OSD fallback (wsprd -o analogue): reliability-ordered re-encoding over
    # the (162, 50) block code on the strongest sync candidates.  top_k
    # output is sorted by score, so the first osd_j slots are the strongest.
    osd = {}
    if cfg.osd_j > 0:
        from cwsl_digi_tpu.modes.osd import flip_patterns, osd_decode

        G, R = _code_matrices()
        j = min(cfg.osd_j, cfg.top_k)
        pats = flip_patterns(N_MSG_BITS, cfg.osd_singles,
                             cfg.osd_tail2, cfg.osd_tail3).astype(np.float32)
        llr_j = llr.reshape(b, cfg.top_k, NSYM)[:, :j]
        cw, dist, nhard = osd_decode(
            jnp.asarray(G), llr_j.reshape(b * j, NSYM), jnp.asarray(pats))
        osd_bits = jnp.mod(
            jnp.dot(cw.astype(jnp.float32), R.astype(np.float32),
                    preferred_element_type=jnp.float32), 2.0)
        osd = {
            "osd_bits": osd_bits.reshape(b, j, N_MSG_BITS).astype(jnp.uint8),
            "osd_dist": dist.reshape(b, j),
            "osd_nhard": nhard.reshape(b, j),
            "osd_wsum": jnp.sum(jnp.abs(llr_j), axis=-1),
        }

    noise = jnp.median(power_sync, axis=(1, 2))
    sig = jnp.abs(top_val) * base[:, :, 0] / NSYM
    # +1.8 dB: calibration vs injected signals of known SNR (tools/snr_check)
    snr = 10.0 * jnp.log10((sig + 1e-30) / (noise[:, None] + 1e-30)) \
        - 10.0 * np.float32(np.log10(2500.0 / TONE_SPACING)) + 1.8

    return {
        "bits": bits,             # [B, K, 50]
        "metric": metric,         # path metric
        "llr": llr.reshape(b, cfg.top_k, 81, 2),
        "score": top_val,
        "t0_hop": t0 - PAD_HOPS,
        "f0_bin": f0 + fmin_bin,
        "drift_idx": d_idx,       # index into cfg.drifts_hz
        "snr": snr,
        **osd,
    }


def _beam_decode(cfg: WSPRConfig, llr):
    """Fixed-width beam search over the 81-step rate-1/2 trellis.

    llr: [N, 81, 2], positive = coded bit 0.  Returns ([N, 50] bits,
    [N] best path metric normalized by total |llr|).
    """
    n = llr.shape[0]
    w = cfg.beam_width
    steps = N_MSG_BITS + N_TAIL

    def step(carry, inp):
        states, metrics, live = carry      # [N, W] uint32, [N, W] f32, [N, W]
        step_llr, is_tail = inp            # [N, 2], scalar
        # branch on bit 0 and bit 1
        s0 = (states << 1) & jnp.uint32(0xFFFFFFFF)
        s1 = s0 | jnp.uint32(1)

        def out_metric(s):
            b1 = (_popcount32(s & jnp.uint32(POLY1)) & 1).astype(jnp.float32)
            b2 = (_popcount32(s & jnp.uint32(POLY2)) & 1).astype(jnp.float32)
            return ((1.0 - 2.0 * b1) * step_llr[:, None, 0]
                    + (1.0 - 2.0 * b2) * step_llr[:, None, 1]) * 0.5

        m0 = metrics + out_metric(s0)
        m1 = metrics + out_metric(s1) - is_tail * jnp.float32(1e9)
        all_states = jnp.concatenate([s0, s1], axis=1)          # [N, 2W]
        all_metrics = jnp.concatenate([m0, m1], axis=1)
        all_live = jnp.concatenate([live, live], axis=1)
        all_metrics = jnp.where(all_live > 0, all_metrics, -jnp.float32(1e9))

        # State merging (M-algorithm / reduced-state Viterbi): future
        # branch metrics depend only on the low 31 register bits (the
        # oldest bit shifts out next step), so survivors equal there are
        # duplicates — keep only the best.  Without this the beam fills
        # with clones of locally-good paths and diversity collapses.
        # Each mergeable key occurs at most twice in the 2W expansion, so
        # one neighbor comparison after a sort suffices.
        key = (all_states & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
        order = jnp.argsort(key, axis=1).astype(jnp.int32)
        k_s = jnp.take_along_axis(key, order, axis=1)
        m_s = jnp.take_along_axis(all_metrics, order, axis=1)
        same_next = k_s[:, :-1] == k_s[:, 1:]
        # drop the worse of an adjacent equal pair (ties: drop the later)
        drop_lo = jnp.pad(same_next & (m_s[:, :-1] < m_s[:, 1:]),
                          ((0, 0), (0, 1)))
        drop_hi = jnp.pad(same_next & (m_s[:, 1:] <= m_s[:, :-1]),
                          ((0, 0), (1, 0)))
        m_s = jnp.where(drop_lo | drop_hi, -jnp.float32(1e9), m_s)

        top_m, top_si = jax.lax.top_k(m_s, w)
        top_i = jnp.take_along_axis(order, top_si.astype(jnp.int32), axis=1)
        new_states = jnp.take_along_axis(all_states, top_i, axis=1)
        new_live = jnp.take_along_axis(all_live, top_i, axis=1)
        # record back-pointers: parent index (mod W) and chosen bit
        parent = (top_i % w).astype(jnp.int32)
        bit = (top_i // w).astype(jnp.int8)
        return (new_states, top_m, new_live), (parent, bit)

    states0 = jnp.zeros((n, w), jnp.uint32)
    metrics0 = jnp.full((n, w), -1e9, jnp.float32)
    metrics0 = metrics0.at[:, 0].set(0.0)   # single live root
    live0 = jnp.zeros((n, w), jnp.float32).at[:, 0].set(1.0)

    llr_t = jnp.transpose(llr, (1, 0, 2))                     # [81, N, 2]
    is_tail = (jnp.arange(steps) >= N_MSG_BITS).astype(jnp.float32)
    (states, metrics, _), (parents, bits) = jax.lax.scan(
        step, (states0, metrics0, live0), (llr_t, is_tail)
    )
    # backtrack best path (index 0 after final top_k sort)
    def backtrack(carry, inp):
        idx = carry                                            # [N]
        parent, bit = inp                                      # [N, W], [N, W]
        b = jnp.take_along_axis(bit, idx[:, None], axis=1)[:, 0]
        nxt = jnp.take_along_axis(parent, idx[:, None], axis=1)[:, 0]
        return nxt, b

    best0 = jnp.argmax(metrics, axis=1).astype(jnp.int32)
    _, rev_bits = jax.lax.scan(
        backtrack, best0, (parents[::-1], bits[::-1])
    )
    path = rev_bits[::-1].T                                    # [N, 81]
    norm = jnp.sum(jnp.abs(llr), axis=(1, 2)) + 1e-30
    best_metric = jnp.max(metrics, axis=1) / (0.5 * norm)
    return path[:, :N_MSG_BITS], best_metric


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------

def _device_batch(n_samples: int) -> int:
    """Windows per device call for windows of ``n_samples``."""
    from cwsl_digi_tpu.modes.gfsk_engine import device_batch_for

    return device_batch_for((n_samples - SPS) // HOP + 1 + 2 * PAD_HOPS,
                            NFFT, 64)


class WSPRDecoder:
    mode = Mode.WSPR

    def __init__(self, top_k: int | None = None, beam_width: int | None = None,
                 cycles: int | None = None):
        # wsprd's cycles-per-bit knob (default 3000, config.ini:217-222;
        # wsprd -C at DecoderPool.hpp:1026).  In wsprd the knob trades CPU
        # for sequential-decoder sensitivity; the parallel beam has no such
        # trade left — recall at -31/-31.7 dB is MEASURED IDENTICAL from
        # (beam 256, 1 pass, osd 4) to (beam 1024, 3 passes, osd 16)
        # because the LLR quality, not the search, is the ceiling
        # (WSPR_CALIBRATION.json).  The honest mapping: low cycles buys
        # the same sensitivity cheaper; high cycles buys search HEADROOM
        # for conditions the stationary parity trials don't exercise —
        # drifting/mistuned real signals (denser drift grid) and crowded
        # sub-bands (more candidates, deeper OSD).
        kw: dict = {}
        if cycles is not None and beam_width is None:
            if cycles <= 500:
                kw = dict(beam_width=256, dd_passes=1, osd_j=4)
            elif cycles >= 10_000:
                kw = dict(beam_width=1024, dd_passes=3, dd_window=6,
                          osd_j=16, top_k=32,
                          drifts_hz=tuple(float(d) for d in range(-4, 5)))
            # 3000-class: defaults
        self.cfg = WSPRConfig(**{
            **kw,
            "top_k": top_k or kw.get("top_k", WSPRConfig.top_k),
            "beam_width": beam_width or kw.get("beam_width",
                                               WSPRConfig.beam_width),
        })
        self._sync = SYNC.astype(np.int32)
        # coded bit k lives at symbol position INTERLEAVE[k], so gathering
        # symbol LLRs with INTERLEAVE yields coded-bit order
        self._deinter = INTERLEAVE
        self._window = np.hanning(SPS).astype(np.float32)

    @property
    def max_device_batch(self) -> int:
        return _device_batch(int(T_R * WAVE_SR))

    def device_call(self, chunk):
        """The jitted decode program and its arguments for one device
        chunk ``[B, N]`` (``program.lower(*args)`` lowers it)."""
        return _decode_program, (self.cfg, (chunk.shape[1],), chunk,
                                 self._sync, self._deinter, self._window)

    def decode_arrays(self, audio: np.ndarray) -> dict[str, np.ndarray]:
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = audio[None, :]
        n = audio.shape[0]
        batch = _device_batch(audio.shape[1])
        if n > batch and (-n) % batch:
            audio = np.concatenate(
                [audio, np.zeros(((-n) % batch, audio.shape[1]), np.float32)])
        chunks = []
        for i in range(0, audio.shape[0], batch):
            program, args = self.device_call(audio[i : i + batch])
            out = program(*args)
            chunks.append({k: np.asarray(v) for k, v in out.items()})
        if len(chunks) == 1:
            return {k: v[:n] for k, v in chunks[0].items()}
        return {k: np.concatenate([c[k] for c in chunks])[:n]
                for k in chunks[0]}

    def decode(self, audio: np.ndarray) -> list[list[DecodeResult]]:
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = audio[None, :]
        out = self.decode_arrays(audio)
        results = []
        n_osd = out["osd_bits"].shape[1] if "osd_bits" in out else 0

        # Single-bit hill-climb polish: the fixed-width beam occasionally
        # commits an early trellis error and lands on a near-codeword (a
        # 1-2 message-bit miss that still unpacks, e.g. a wrong power
        # field).  The code is linear, so each message-bit flip XORs a
        # precomputed 162-bit pattern into the codeword; one [50,162]
        # matvec scores all flips and the climb takes the best until no
        # flip improves the LLR correlation.  At easy SNR this recovers
        # any 1-bit miss by construction (the true codeword correlates
        # strictly higher), at the cost of 4 matvecs per candidate.
        flip_pat = _code_matrices()[0].astype(np.float64)   # [50, 162]

        def polish(bits: np.ndarray, llr: np.ndarray) -> np.ndarray:
            best = np.asarray(bits, np.uint8).copy()
            coded_signs = 1.0 - 2.0 * conv_encode(best).astype(np.float64)
            for _ in range(4):
                # delta_i = -2 * sum_j pat[i,j] * coded_signs_j * llr_j
                d = -2.0 * (flip_pat @ (coded_signs * llr))
                i = int(np.argmax(d))
                if d[i] <= 1e-12:
                    break
                best[i] ^= 1
                coded_signs = 1.0 - 2.0 * conv_encode(best).astype(np.float64)
            return best

        def accept(score: float, llr: np.ndarray, coded: np.ndarray) -> bool:
            # Validation gates (WSPR has no CRC; wsprd gates on sync +
            # unpack sanity).  Two-tier boundary, recalibrated on the
            # round-5 demod (frequency-residual correction + 4-symbol
            # coherence changed both signal and noise statistics): 6144
            # POLISHED noise beam/OSD candidates over 192 noise windows
            # never exceed sync score 0.221, never reach agree >= 0.90
            # with nhard <= 30 in the same fit (the joint gate is what
            # buys the margin — noise trades agreement against hard
            # errors, true decodes don't).  True decodes at -31 dB:
            # agree med 0.91, score 0.17-0.29.  The old gates (agree
            # 0.925 / score 0.23) were rejecting half the -31 dB misses
            # WITH the true bits already decoded.
            x = (1.0 - 2.0 * coded.astype(np.float32)) * llr
            agree = float(np.sum(np.where(x > 0, np.abs(llr), 0.0))
                          / (np.sum(np.abs(llr)) + 1e-30))
            nhard = int(np.sum(x < 0))
            tier1 = score >= 0.225 and agree >= 0.85 and nhard <= 40
            tier2 = score >= 0.16 and agree >= 0.90 and nhard <= 30
            return tier1 or tier2

        for wi in range(audio.shape[0]):
            seen: dict[str, DecodeResult] = {}
            for k in range(self.cfg.top_k):
                cand_bits = [out["bits"][wi, k]]
                if k < n_osd:
                    # OSD fallback bits (wsprd -o analogue)
                    cand_bits.append(out["osd_bits"][wi, k])
                score = float(out["score"][wi, k])
                llr = out["llr"][wi, k].reshape(162)
                r = None
                for bits in cand_bits:
                    bits = polish(bits, llr)
                    try:
                        call, grid, dbm = unpack_message(bits)
                    except ValueError:
                        continue
                    if accept(score, llr, conv_encode(bits)):
                        r = (bits, call, grid, dbm)
                        break
                if r is None:
                    continue
                bits, call, grid, dbm = r
                text = f"{call} {grid} {dbm}"
                dt = out["t0_hop"][wi, k] * HOP / WAVE_SR - SIGNAL_START_S
                r = DecodeResult(
                    message=text,
                    snr_db=round(float(out["snr"][wi, k]), 1),
                    dt_s=round(float(dt), 2),
                    freq_hz=round(float(out["f0_bin"][wi, k] * BIN_HZ), 2),
                    score=float(out["score"][wi, k]),
                    mode=Mode.WSPR,
                    payload_bits=bits.copy(),
                    drift_hz=float(self.cfg.drifts_hz[out["drift_idx"][wi, k]]),
                )
                prev = seen.get(call)
                if prev is None or r.score > prev.score:
                    seen[call] = r
            # frequency-proximity suppression: sync sidelobes of a strong
            # burst can support a junk beam fit at a nearby (t0, f0); two
            # real WSPR signals closer than ~4 Hz cannot both decode anyway
            # (the 4-FSK occupies ~6 Hz), so keep only the best per cluster
            accepted: list[DecodeResult] = []
            for r in sorted(seen.values(), key=lambda r: -r.score):
                if any(abs(r.freq_hz - a.freq_hz) < 4.0 for a in accepted):
                    continue
                accepted.append(r)
            results.append(accepted)
        return results
