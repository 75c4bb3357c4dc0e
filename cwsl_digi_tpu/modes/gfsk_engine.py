"""Generic batched decoder engine for GFSK sync-array modes.

FT8, FT4, JS8 and the FST4/FST4W family share one physical-layer shape:
n-GFSK symbols at fixed baud, known sync symbols at known positions, the
remaining symbols carrying Gray-mapped codeword bits protected by an LDPC
code + CRC.  The reference treats each as a different external binary
(jt9 -8/-5/-7/-W, js8), but here they are all the SAME fixed-shape program
with different static parameters:

  1. power spectrogram: frames of ``sps`` samples, hop ``sps/4``, rfft
     zero-padded 2x -> half-tone-spacing frequency bins;
  2. sync correlation: one shifted-slice add per known sync cell;
  3. top-K candidates over (start hop, base bin);
  4. tone-energy gather -> max-log LLRs;
  5. batched min-sum LDPC + matrix CRC -> validity mask.

``ModeSpec`` is hashable, so one jitted program per (spec, window length).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from cwsl_digi_tpu.constants import WAVE_SR
from cwsl_digi_tpu.modes.ldpc import BPDecoder, Code


# device-memory budget per decode program call (two spectrograms + the
# complex rfft intermediate).  Not yet calibrated on the H100: chip_smoke.py
# prints each mode's resulting batch and compiled memory for that.
DEVICE_BYTES_BUDGET = 4_000_000_000


def device_batch_for(n_hops: int, nfft: int, cap: int,
                     cand_bytes: int = 0) -> int:
    """Windows per device call so the spectrogram working set fits the
    device budget."""
    # sync power f32 + complex demod stft c64 + rfft intermediate c64
    per_window = n_hops * (nfft // 2 + 1) * (4 + 8 + 8) + cand_bytes
    return max(1, min(cap, DEVICE_BYTES_BUDGET // max(per_window, 1)))


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """Static physical-layer description of one GFSK mode."""

    name: str
    n_sym: int                    # total symbols
    sps: int                      # samples per symbol @ 12 kHz
    n_tones: int
    bits_per_sym: int
    sync_cells: tuple[tuple[int, int], ...]   # (symbol index, tone)
    data_syms: tuple[int, ...]    # symbol indices carrying codeword bits
    gray_map: tuple[int, ...]     # bits value -> tone
    trperiod: float
    signal_start_s: float = 0.5
    fmin_hz: float = 200.0
    fmax_hz: float = 3000.0
    # decoder knobs
    top_k: int = 128
    bp_iters: int = 30
    max_hops: int = 128           # candidate start-time grid
    pad_hops: int = 64
    os_t: int = 4                 # time oversampling (hops per symbol)
    os_f: int = 2                 # freq oversampling (bins per tone step)
    nms: bool = False             # NMS loses the multi-offset candidates that
                                  # rescue off-grid signals; keep all cells
    depth: int = 2                # decode passes with signal subtraction
                                  # (reference decodedepth, config.ini:213)
    bt: float = 2.0               # GFSK Gaussian BT (for reconstruction)
    # OSD fallback (deep decode, ≙ jt9 -d 3 behavior): J BP-failed
    # candidates per window get an ordered-statistics pass; 0 disables
    # (GFSKDecoder forces 0 when depth==1, ≙ jt9 -d 1 "fast").
    osd_j: int = 16
    osd_singles: int = 91         # flip-pattern budget (see modes/osd.py)
    osd_tail2: int = 16
    osd_tail3: int = 8
    osd_nhard_max: int = 42       # acceptance gates (calibrated: see
    osd_dist_frac: float = 0.12   # tools/osd_calibrate.py)
    osd_post: bool = True         # order bits by BP posteriors (vs channel)
    # weak-candidate gates (jt9's ft8b): a candidate whose hard sync count
    # (sync symbols whose known tone is the symbol's strongest) is at most
    # sync_min, or at most weak_sync with an SNR below snr_floor_db, is
    # likely noise and never decodes.  -1 disables.
    sync_min: int = -1
    weak_sync: int = -1
    snr_floor_db: float = -99.0
    # OSD always returns a codeword, and on noise one in 2^14 passes the
    # CRC: it runs only on candidates whose hard sync count is above
    # osd_sync_min
    osd_sync_min: int = -1
    snr_offset_db: float = 0.0    # per-mode SNR calibration (tools/snr_check)
    # Sub-grid candidate refinement (DFT-matmul path only): demod reads a
    # half-hop-finer boxcar spectrogram at the parabolic-interpolated sync
    # peak, and the fractional-bin frequency residual rotates the coherent
    # combiner's reference phase.  Recovers most of the off-grid loss
    # (measured FT8: 59% -> ~88% recall at -21 dB) for 1.5x the DFT work,
    # where a globally finer grid (os_t/os_f doubled) costs 4x.
    refine: bool = False
    # Frequency-only refinement: fold the sync-pair phase estimate of the
    # sub-bin residual into the coherent combiner WITHOUT the half-hop
    # spectrogram (no extra memory/compute).  Matters most for the slow
    # modes: at FST4W's baud a +-bin/2 residual is +-spacing/8 -> 0.79 rad
    # of phase rotation PER SYMBOL, which guts the 2/3-symbol coherent
    # metrics the engine relies on (cos(0.79) ~ 0.7 per pair term).
    refine_freq: bool = False
    # 4-symbol coherent metrics (two sliding windows per data symbol, max
    # over the 3 unknown neighbors).  T^4 neighbor combos per symbol —
    # affordable for 4-FSK (256), gated off for 8-FSK throughput modes.
    coh4: bool = False

    @property
    def hop(self) -> int:
        return self.sps // self.os_t

    @property
    def nfft(self) -> int:
        return self.os_f * self.sps

    @property
    def bin_hz(self) -> float:
        return WAVE_SR / self.nfft

    @property
    def baud(self) -> float:
        return WAVE_SR / self.sps

    @property
    def tone_spacing(self) -> float:
        return self.baud

    @property
    def n_bits(self) -> int:
        return len(self.data_syms) * self.bits_per_sym

    def inverse_gray(self) -> np.ndarray:
        return np.argsort(np.asarray(self.gray_map)).astype(np.int32)

    def tones_from_codeword(self, codeword: np.ndarray) -> np.ndarray:
        """codeword bits -> full symbol/tone sequence (encoder side)."""
        codeword = np.asarray(codeword, np.uint8)
        assert codeword.shape == (self.n_bits,)
        vals = codeword.reshape(len(self.data_syms), self.bits_per_sym)
        v = np.zeros(len(self.data_syms), np.int64)
        for b in range(self.bits_per_sym):
            v = v * 2 + vals[:, b]
        gray = np.asarray(self.gray_map)
        tones = np.zeros(self.n_sym, np.int32)
        for s, tone in self.sync_cells:
            tones[s] = tone
        tones[np.asarray(self.data_syms)] = gray[v]
        return tones

    def bitmaps(self) -> np.ndarray:
        """[bits_per_sym, n_tones]: bit j of each tone's Gray value."""
        ig = self.inverse_gray()
        out = np.zeros((self.bits_per_sym, self.n_tones), np.float32)
        for tone in range(self.n_tones):
            v = int(ig[tone])
            for j in range(self.bits_per_sym):
                out[j, tone] = (v >> (self.bits_per_sym - 1 - j)) & 1
        return out


def _multisym_llrs(spec: ModeSpec, csym: jax.Array, rot: jax.Array,
                   bitmaps: jax.Array) -> jax.Array:
    """Coherent 1/2/3-symbol max-log LLRs.

    csym: [M, n_sym, n_tones] complex symbol DFT values (boxcar, candidate
    aligned); rot: [M] inter-symbol reference phase rotation; returns
    [M, n_bits] LLRs, per-candidate normalized to std 3 (the BP operating
    range the gates are calibrated for).

    Per data symbol s the metric combines, with equal weight:
      E1   = |C_s|^2 per tone
      E2p  = max over allowed prev tones of |C_{s-1} + rot*C_s|^2
      E2n  = max over allowed next tones of |C_s + rot*C_{s+1}|^2
      E3   = max over allowed (prev, next) of the 3-symbol coherent sum
    "Allowed" is the known sync tone when the neighbor is a sync cell, all
    tones when it is data, and handled by zero padding at sequence edges.
    Expanded via |a+b|^2 = |a|^2+|b|^2+2Re(conj(a)b) so only [T,T(,T)]
    cross tensors are materialized, chunked over candidates to bound device memory.
    """
    m_all, n_sym, n_tones = csym.shape
    data = np.asarray(spec.data_syms, np.int64)
    n_data = len(data)
    big = jnp.float32(1e30)

    # static neighbor-tone masks (True = allowed)
    known = np.full(n_sym, -1, np.int64)
    for s, t in spec.sync_cells:
        known[s] = t

    def neighbor_allowed(idx: np.ndarray) -> np.ndarray:
        out = np.ones((n_data, n_tones), bool)
        for di, s in enumerate(idx):
            if 0 <= s < n_sym and known[s] >= 0:
                out[di] = False
                out[di, known[s]] = True
        return out

    allow_prev = jnp.asarray(neighbor_allowed(data - 1))
    allow_next = jnp.asarray(neighbor_allowed(data + 1))
    allow_prev2 = jnp.asarray(neighbor_allowed(data - 2))
    allow_next2 = jnp.asarray(neighbor_allowed(data + 2))
    bit0 = bitmaps < 0.5                          # [bits_per_sym, n_tones]

    # chunk size: bound the largest cross tensor to ~64 MB
    tri_bytes = n_data * n_tones ** (4 if spec.coh4 else 3) * 4
    chunk = int(max(1, min(m_all, 64_000_000 // max(tri_bytes, 1))))

    def one_chunk(args):
        c, r = args                               # [m, S, T] c64, [m] c64
        cpad = jnp.pad(c, ((0, 0), (1, 1), (0, 0)))
        cs = c[:, data]                           # [m, D, T]
        cprev = cpad[:, data]                     # real index s-1
        cnext = cpad[:, data + 2]                 # real index s+1
        r_ = r[:, None, None, None]
        e1s = jnp.abs(cs) ** 2
        e1p = jnp.abs(cprev) ** 2
        e1n = jnp.abs(cnext) ** 2
        # cross terms, [m, D, T, T]
        x_ps = 2.0 * jnp.real(jnp.conj(cprev)[:, :, :, None]
                              * (r_ * cs[:, :, None, :]))
        x_sn = 2.0 * jnp.real(jnp.conj(cs)[:, :, :, None]
                              * (r_ * cnext[:, :, None, :]))
        x_pn = 2.0 * jnp.real(jnp.conj(cprev)[:, :, :, None]
                              * (r_ * r_ * cnext[:, :, None, :]))
        # pair metrics marginalized over the (masked) neighbor
        gp = jnp.where(allow_prev[None, :, :, None],
                       e1p[:, :, :, None] + x_ps, -big)
        e2p = e1s + jnp.max(gp, axis=2)           # [m, D, T]
        gn = jnp.where(allow_next[None, :, None, :],
                       e1n[:, :, None, :] + x_sn, -big)
        e2n = e1s + jnp.max(gn, axis=3)
        # triple metric, [m, D, Tprev, Tself, Tnext] -> max over prev/next
        tri = (e1p[:, :, :, None, None] + e1s[:, :, None, :, None]
               + e1n[:, :, None, None, :]
               + x_ps[:, :, :, :, None] + x_sn[:, :, None, :, :]
               + x_pn[:, :, :, None, :])
        tri = jnp.where(allow_prev[None, :, :, None, None], tri, -big)
        tri = jnp.where(allow_next[None, :, None, None, :], tri, -big)
        e3 = jnp.max(tri, axis=(2, 4))            # [m, D, T]

        def bit_llrs(f):                          # f: [m, D, T] -> [m, D, nb]
            f_ = f[:, :, None, :]
            b0 = jnp.max(jnp.where(bit0[None, None], f_, -big), axis=-1)
            b1 = jnp.max(jnp.where(~bit0[None, None], f_, -big), axis=-1)
            return b0 - b1

        l = bit_llrs(e1s) + bit_llrs(e2p) + bit_llrs(e2n) + bit_llrs(e3)
        if spec.coh4:
            # two 4-symbol coherent windows per data symbol: [s-1..s+2]
            # and [s-2..s+1], each maxed over the 3 unknown neighbors.
            # The slow FST4 bauds reward the longer coherence; the extra
            # cross tensors reuse the |a+b|^2 expansion.
            cprev2 = jnp.pad(c, ((0, 0), (2, 2), (0, 0)))[:, data]  # s-2
            cnext2 = jnp.pad(c, ((0, 0), (2, 2), (0, 0)))[:, data + 4]
            e1p2 = jnp.abs(cprev2) ** 2
            e1n2 = jnp.abs(cnext2) ** 2
            r2_ = r_ * r_
            r3_ = r2_ * r_

            def cross(a, bb_, rr):                # 2Re(conj(a) rr b)
                return 2.0 * jnp.real(jnp.conj(a)[:, :, :, None]
                                      * (rr * bb_[:, :, None, :]))

            x_p_nn = cross(cprev, cnext2, r3_)    # (s-1, s+2)
            x_s_nn = cross(cs, cnext2, r2_)       # (s,   s+2)
            x_n_nn = cross(cnext, cnext2, r_)     # (s+1, s+2)
            x_pp_p = cross(cprev2, cprev, r_)     # (s-2, s-1)
            x_pp_s = cross(cprev2, cs, r2_)       # (s-2, s)
            x_pp_n = cross(cprev2, cnext, r3_)    # (s-2, s+1)

            # window [s-1, s, s+1, s+2]: axes (p, self, n, q)
            w4n = (e1p[:, :, :, None, None, None]
                   + e1s[:, :, None, :, None, None]
                   + e1n[:, :, None, None, :, None]
                   + e1n2[:, :, None, None, None, :]
                   + x_ps[:, :, :, :, None, None]
                   + x_pn[:, :, :, None, :, None]
                   + x_p_nn[:, :, :, None, None, :]
                   + x_sn[:, :, None, :, :, None]
                   + x_s_nn[:, :, None, :, None, :]
                   + x_n_nn[:, :, None, None, :, :])
            w4n = jnp.where(allow_prev[None, :, :, None, None, None],
                            w4n, -big)
            w4n = jnp.where(allow_next[None, :, None, None, :, None],
                            w4n, -big)
            w4n = jnp.where(allow_next2[None, :, None, None, None, :],
                            w4n, -big)
            e4n = jnp.max(w4n, axis=(2, 4, 5))    # [m, D, T]

            # window [s-2, s-1, s, s+1]: axes (q2, p, self, n)
            w4p = (e1p2[:, :, :, None, None, None]
                   + e1p[:, :, None, :, None, None]
                   + e1s[:, :, None, None, :, None]
                   + e1n[:, :, None, None, None, :]
                   + x_pp_p[:, :, :, :, None, None]
                   + x_pp_s[:, :, :, None, :, None]
                   + x_pp_n[:, :, :, None, None, :]
                   + x_ps[:, :, None, :, :, None]
                   + x_pn[:, :, None, :, None, :]
                   + x_sn[:, :, None, None, :, :])
            w4p = jnp.where(allow_prev2[None, :, :, None, None, None],
                            w4p, -big)
            w4p = jnp.where(allow_prev[None, :, None, :, None, None],
                            w4p, -big)
            w4p = jnp.where(allow_next[None, :, None, None, None, :],
                            w4p, -big)
            e4p = jnp.max(w4p, axis=(2, 3, 5))    # [m, D, T]
            l = l + bit_llrs(e4n) + bit_llrs(e4p)
        return l.reshape(l.shape[0], -1)          # [m, n_bits]

    pad = (-m_all) % chunk
    if pad:
        csym = jnp.concatenate(
            [csym, jnp.zeros((pad, n_sym, n_tones), csym.dtype)])
        rot = jnp.concatenate([rot, jnp.ones((pad,), rot.dtype)])
    n_chunks = csym.shape[0] // chunk
    llr = jax.lax.map(
        one_chunk,
        (csym.reshape(n_chunks, chunk, n_sym, n_tones),
         rot.reshape(n_chunks, chunk)),
    ).reshape(n_chunks * chunk, -1)[:m_all]
    # per-candidate scale normalization (energies are scale-dependent).
    # Prescale by the max magnitude BEFORE the variance: long-FST4 frames
    # at int16 scale put per-bin energies near 1e18, whose squares summed
    # over n_bits overflow float32 inside jnp.std (inf std -> zero LLRs ->
    # a strong FST4W-900/1800 burst silently failing to decode; found by
    # the dryrun signal injection).
    peak = jnp.max(jnp.abs(llr), axis=-1, keepdims=True)
    llr = llr / (peak + 1e-20)
    std = jnp.std(llr, axis=-1, keepdims=True)
    return llr / (std + 1e-20) * 3.0


@functools.partial(jax.jit, static_argnums=(0, 1, 6))
def decode_program(
    spec: ModeSpec,
    shapes: tuple,                 # (n_samples,)
    audio: jax.Array,              # [B, N] float32
    crc_mat: jax.Array,            # [n_payload, n_crc] float32
    bitmaps: jax.Array,           # [bits_per_sym, n_tones] float32
    window: jax.Array,             # [sps] analysis window
    bp: BPDecoder,                 # static (hashable, holds NumPy tables only)
    data_syms: jax.Array,          # [n_data] int32
    ap_mask: jax.Array | None = None,   # [H, n_code] 1=bit known (AP)
    ap_vals: jax.Array | None = None,   # [H, n_code] known bit values
    dft_mat: jax.Array | None = None,   # [sps, 4*n_bins] DFT-as-matmul
):
    (n_samples,) = shapes
    b = audio.shape[0]
    sps, hop, nfft = spec.sps, spec.hop, spec.nfft
    n_hops = (n_samples - sps) // hop + 1
    fmin_bin = int(spec.fmin_hz / spec.bin_hz)
    # upper band edge inclusive (reference nfa..nfb is a closed range):
    # +1 so a signal at exactly fmax_hz still has an f0 candidate
    fmax_bin = int(np.ceil(spec.fmax_hz / spec.bin_hz)) + 1
    n_bins = fmax_bin - fmin_bin + spec.os_f * spec.n_tones

    # --- 1. spectrograms --------------------------------------------------
    # Two windows over the same frames: the tapered `window` (Hanning) for
    # the sync search (sidelobe suppression matters there), and a boxcar for
    # the tone-energy demod — the matched filter for constant-tone symbols.
    # The window mismatch is worth ~1.5 dB of sensitivity at the decode
    # threshold (measured: 92% -> 100% recall at -18 dB for FT8).
    # The boxcar spectrogram is kept COMPLEX: the demod stage combines
    # adjacent symbols coherently (GFSK phase continuity), which needs the
    # cross terms, not just the energies.
    idx = jnp.arange(n_hops)[:, None] * hop + jnp.arange(sps)[None, :]
    frames = audio[:, idx]

    refine = spec.refine and dft_mat is not None
    stft_f = None
    if refine:
        # Split the fused DFT: Hann columns at the coarse hop for the sync
        # search, boxcar columns at HALF the hop for the demod gather.
        # Total matmul work is 1.5x the fused 4-column version — far from
        # the 4x of a globally doubled (os_t, os_f) grid — and the sync
        # accumulation (the memory-bound stage) is untouched.
        n_bins_k = dft_mat.shape[1] // 4
        four = jnp.einsum(
            "is,sj->ij",
            frames.reshape(b * n_hops, sps).astype(jnp.bfloat16),
            dft_mat[:, 2 * n_bins_k:].astype(jnp.bfloat16),
            preferred_element_type=jnp.float32)
        four = four.reshape(b, n_hops, 2, n_bins_k)
        pad = ((0, 0), (spec.pad_hops, spec.pad_hops), (0, 0))
        power_sync = jnp.pad(four[:, :, 0] ** 2 + four[:, :, 1] ** 2,
                             pad).astype(jnp.bfloat16)
        hop_f = hop // 2
        n_hops_f = 2 * n_hops - 1
        idx_f = (jnp.arange(n_hops_f)[:, None] * hop_f
                 + jnp.arange(sps)[None, :])
        fd = jnp.einsum(
            "is,sj->ij",
            audio[:, idx_f].reshape(b * n_hops_f, sps).astype(jnp.bfloat16),
            dft_mat[:, : 2 * n_bins_k].astype(jnp.bfloat16),
            preferred_element_type=jnp.float32)
        fd = fd.reshape(b, n_hops_f, 2, n_bins_k)
        stft_f = jnp.pad(jax.lax.complex(fd[:, :, 0], fd[:, :, 1]),
                         ((0, 0), (2 * spec.pad_hops, 2 * spec.pad_hops),
                          (0, 0)))
    elif dft_mat is not None:
        # DFT as a matmul over only the kept bins: one dense [sps,
        # 4*n_bins] contraction (boxcar re/im + Hann re/im fused) with
        # bf16 inputs and f32 accumulation; the 0.4% input quantization
        # sits ~48 dB below the noise floor, invisible at any decodable
        # SNR.  Long FST4 modes keep the FFT (their DFT matrix would not
        # fit; see GFSKDecoder._dft_mat).
        four = jnp.einsum(
            "is,sj->ij",
            frames.reshape(b * n_hops, sps).astype(jnp.bfloat16),
            dft_mat.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32)
        four = four.reshape(b, n_hops, 4, n_bins)
        pad = ((0, 0), (spec.pad_hops, spec.pad_hops), (0, 0))
        # bf16 sync spectrogram: the 21-cell accumulation below is pure memory
        # bandwidth; half-width cells halve it (ranking scores tolerate the
        # 0.4% relative quantization with orders of magnitude to spare)
        power_sync = jnp.pad(four[:, :, 2] ** 2 + four[:, :, 3] ** 2,
                             pad).astype(jnp.bfloat16)
        stft = jnp.pad(jax.lax.complex(four[:, :, 0], four[:, :, 1]), pad)
    else:
        def spectrogram(w, keep_complex=False):
            x = jnp.fft.rfft(frames * w[None, None, :], n=nfft, axis=-1)
            x = x[:, :, fmin_bin : fmin_bin + n_bins]
            x = jnp.pad(x, ((0, 0), (spec.pad_hops, spec.pad_hops), (0, 0)))
            return x if keep_complex else (
                jnp.abs(x) ** 2).astype(jnp.bfloat16)

        power_sync = spectrogram(window)
        stft = spectrogram(jnp.ones((sps,), jnp.float32), keep_complex=True)

    # --- 2. sync correlation ----------------------------------------------
    n_t0 = spec.max_hops
    n_f0 = fmax_bin - fmin_bin
    acc = jnp.zeros((b, n_t0, n_f0), jnp.float32)
    for sym, tone in spec.sync_cells:
        h0, b0 = spec.os_t * sym, spec.os_f * tone
        acc = acc + jax.lax.slice(power_sync, (0, h0, b0),
                                  (b, h0 + n_t0, b0 + n_f0)
                                  ).astype(jnp.float32)
    # normalization statistics over the REAL (unpadded) spectrogram rows,
    # so the pad fraction (which varies per mode) cannot bias the score or
    # the SNR estimate
    real_rows = jax.lax.slice(
        power_sync, (0, spec.pad_hops, 0),
        (b, spec.pad_hops + n_hops, power_sync.shape[2])
    ).astype(jnp.float32)
    base = jnp.mean(real_rows, axis=(1, 2), keepdims=True) * len(spec.sync_cells)
    score = acc / (base + 1e-30)

    # --- 3. top-K candidates ----------------------------------------------
    # Hybrid selection: half the slots from the non-max-suppressed map
    # (each slot is a DISTINCT sync peak — crowded bands need breadth) and
    # half from the raw map (adjacent-offset duplicates of the strongest
    # peaks — off-grid signals at threshold need the retries).  Measured:
    # raw-only decodes 8/24 of a crowded band, NMS-only loses ~2 dB of
    # single-signal threshold; the hybrid gets both.
    flat = score.reshape(b, -1)
    neigh = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max,
        (1, spec.os_t + 1, spec.os_f + 1), (1, 1, 1), "SAME",
    )
    flat_nms = jnp.where(score >= neigh, score, 0.0).reshape(b, -1)
    k_nms = spec.top_k // 2
    v1, i1 = jax.lax.top_k(flat_nms, k_nms)
    v2, i2 = jax.lax.top_k(flat, spec.top_k - k_nms)
    top_val = jnp.concatenate([v1, v2], axis=1)
    top_idx = jnp.concatenate([i1, i2], axis=1)
    t0 = top_idx // n_f0
    f0 = top_idx % n_f0

    # --- 4. coherent multi-symbol demod -> LLRs -----------------------------
    # GFSK phase is continuous across symbols, and for every mode here the
    # tone spacing equals the baud rate, so the reference waveform's
    # inter-symbol DFT phase is tone-independent: theta0 = 2*pi*bin/os_f.
    # Combining 2- and 3-symbol coherent metrics with the single-symbol
    # energies is worth ~1.5 dB at the decode threshold (the jt9 decoder's
    # nsym=1/2/3 metrics); sync-adjacent data symbols additionally
    # constrain the neighbor tone to the known sync tone.
    # Candidate (t0, f0) needs stft[t0 + os_t*s, f0 + os_f*j] for all
    # (symbol s, tone j) — a STRIDED 2D block.  A naive fancy-index gather
    # loads 15M scalars at random addresses; instead re-layout the
    # spectrogram so the strides become unit: split hop = q*os_t + rt and
    # bin = p*os_f + rf, move (rt, rf) to leading axes, and each
    # candidate's block is the CONTIGUOUS slice [q : q+n_sym, p : p+n_tones]
    # of plane (rt, rf).  One vmapped dynamic_slice then fetches 79x8
    # blocks instead of scalars.
    src = stft_f if refine else stft
    os_t_eff = (2 * spec.os_t) if refine else spec.os_t
    n_hops_src = src.shape[1]
    hq = -(-n_hops_src // os_t_eff)
    fq = -(-src.shape[2] // spec.os_f)
    stft_r = jnp.pad(src, ((0, 0), (0, hq * os_t_eff - n_hops_src),
                           (0, fq * spec.os_f - src.shape[2])))
    stft_r = stft_r.reshape(b, hq, os_t_eff, fq, spec.os_f)
    # hop axis LAST: each gathered block row is then n_sym contiguous
    # complex values (~half a KB DMA transfer) instead of n_tones (64 B)
    stft_r = stft_r.transpose(0, 2, 4, 3, 1)   # [b, os_t, os_f, fq, hq]

    def slice_block(planes, tt_, ff):
        # planes: [os_t_eff, os_f, fq, hq]; block gather of one candidate
        blk = jax.lax.dynamic_slice(
            planes, (tt_ % os_t_eff, ff % spec.os_f,
                     ff // spec.os_f, tt_ // os_t_eff),
            (1, 1, spec.n_tones, spec.n_sym))
        return blk[0, 0]

    def gather(tt_, ff):
        c = jax.vmap(jax.vmap(slice_block, in_axes=(None, 0, 0)))(
            stft_r, tt_, ff)
        return c.transpose(0, 1, 3, 2)    # [B, K, n_sym, n_tones] c64

    if refine:
        # --- 4a. decision-directed sub-grid refinement --------------------
        # Time: evaluate the sync cells at the three half-hop offsets
        # around the coarse peak and keep the offset with the most
        # matched-filter (boxcar) sync energy.  This beats interpolating
        # the Hann sync score — it measures the actual per-candidate
        # alignment instead of fitting a parabola to a triangular,
        # noise-limited peak (measured FT8 -21 dB: parabola 69%,
        # decision-directed 81%).  Computed as a fine-grid sync-energy
        # map via the same shifted-slice accumulation as stage 2 (the
        # formulation XLA compiles and runs well), then three
        # per-candidate lookups.
        powf = jnp.pad(
            (jnp.abs(stft_f) ** 2).astype(jnp.bfloat16),
            ((0, 0), (1, 1), (0, 0)))
        n_tf = 2 * n_t0 + 1                       # fine rows, offset by -1
        accf = jnp.zeros((b, n_tf, n_f0), jnp.float32)
        for sym, tone in spec.sync_cells:
            h0, b0 = 2 * spec.os_t * sym, spec.os_f * tone
            accf = accf + jax.lax.slice(
                powf, (0, h0, b0), (b, h0 + n_tf, b0 + n_f0)
            ).astype(jnp.float32)
        accf = accf.reshape(b, n_tf * n_f0)
        idx3 = ((2 * t0[:, :, None]
                 + jnp.arange(3, dtype=t0.dtype)[None, None, :]) * n_f0
                + f0[:, :, None])                 # row r = fine hop r-1
        e3 = jnp.take_along_axis(
            accf, idx3.reshape(b, -1), axis=1).reshape(b, spec.top_k, 3)
        delta = jnp.argmax(e3, axis=-1).astype(t0.dtype) - 1
        # Clamp the refined hop into [0, n_hops_src - 1]: a sync peak at
        # padded hop 0 with delta=-1 would otherwise wrap tt % os_t_eff to
        # os_t_eff-1 while dynamic_slice clamps tt // os_t_eff to 0,
        # silently gathering from the wrong half-hop plane for that edge
        # candidate.
        tt_ref = jnp.clip(2 * t0 + delta, 0, n_hops_src - 1)
        csym = gather(tt_ref, f0)
    else:
        csym = gather(t0, f0)
    abs_bin = (f0 + fmin_bin).astype(jnp.float32)
    rot = jnp.exp(-2j * jnp.pi * abs_bin / spec.os_f)            # [B, K]
    ss = np.asarray([s for s, _ in spec.sync_cells])
    st = np.asarray([t for _, t in spec.sync_cells])
    # hard sync count per candidate (jt9's nsync)
    nsync = jnp.sum(jnp.argmax(jnp.abs(csym[:, :, ss, :]), axis=-1) == st,
                    axis=-1)                                      # [B, K]
    if refine or spec.refine_freq:
        # Frequency: the sub-bin residual df shows up as a common extra
        # phase rotation 2*pi*df*T_sym between consecutive symbols.
        # Estimate it from consecutive SYNC-cell pairs (known tones) —
        # arg of the pair-product sum is the ML estimator of the residual
        # (~0.13 Hz rms at -21 dB from 18 pairs) — and fold it into the
        # combiner's reference rotation.  Unambiguous over +-baud/2, far
        # beyond the +-bin/2 residual it corrects.  The within-symbol
        # scalloping at <= bin/2 is < 0.1 dB and ignored.
        by_sym = {int(s): int(t) for s, t in zip(ss, st)}
        pairs = [(s, by_sym[s + 1], by_sym[s])
                 for s in sorted(by_sym) if s + 1 in by_sym]
        if pairs:
            p_sym = jnp.asarray([p[0] for p in pairs], jnp.int32)
            p_tn = jnp.asarray([p[2] for p in pairs], jnp.int32)
            p_tn1 = jnp.asarray([p[1] for p in pairs], jnp.int32)
            cs = csym[:, :, p_sym, p_tn]                  # [B, K, n_pairs]
            cn = csym[:, :, p_sym + 1, p_tn1]
            z = jnp.sum(jnp.conj(cs) * cn, axis=-1) * rot
            rot = rot * jnp.exp(-1j * jnp.angle(z))
    llr = _multisym_llrs(
        spec, csym.reshape(b * spec.top_k, spec.n_sym, spec.n_tones),
        rot.reshape(-1), bitmaps,
    ).reshape(b, spec.top_k, spec.n_bits)

    # --- 4b. a-priori hypotheses ------------------------------------------
    # The reference forwards AP flags to jt9 (source/DecoderPool.hpp:466-469);
    # natively each hypothesis forces its known bits to saturated LLRs and
    # the candidate axis widens to K*H (wrong hypotheses die at the CRC).
    k_eff = spec.top_k
    if ap_mask is not None:
        h = ap_mask.shape[0]
        big_ap = jnp.float32(50.0)
        llr_h = (llr[:, :, None, :] * (1.0 - ap_mask[None, None])
                 + big_ap * (1.0 - 2.0 * ap_vals[None, None]) * ap_mask[None, None])
        llr = llr_h.reshape(b, spec.top_k * h, spec.n_bits)
        k_eff = spec.top_k * h
        t0 = jnp.repeat(t0, h, axis=1)
        f0 = jnp.repeat(f0, h, axis=1)
        top_val = jnp.repeat(top_val, h, axis=1)
        nsync = jnp.repeat(nsync, h, axis=1)

    # --- SNR estimate ------------------------------------------------------
    # mean sync-cell power = signal + average cell noise; subtract the noise
    # term (score units: top_val ~= (S+N)/N_mean, so S/N_mean = top_val - 1)
    # and reference to 2.5 kHz like every reference-reported SNR.
    # The noise floor is a median over a 4x4-subsampled grid: a full median
    # sorts ~1.4 M cells/window on device for a statistic whose estimator
    # noise is identical at 1/16 the samples.
    noise = jnp.median(real_rows[:, ::4, ::4], axis=(1, 2))
    mean_cell = base[:, :, 0] / len(spec.sync_cells)
    sig = jnp.maximum(top_val - 1.0, 0.01) * mean_cell
    # -0.6 dB: empirical calibration against injected signals of known SNR
    # (median-vs-mean noise statistic + window scalloping), validated at
    # +5..-18 dB to within ~0.5 dB
    snr = 10.0 * jnp.log10((sig + 1e-30) / (noise[:, None] + 1e-30)) \
        - 10.0 * np.float32(np.log10(2500.0 / spec.tone_spacing)) - 0.6 \
        + np.float32(spec.snr_offset_db)
    weak = (nsync <= spec.sync_min) | (
        (nsync <= spec.weak_sync) & (snr < spec.snr_floor_db))

    # --- 5. LDPC + CRC ----------------------------------------------------
    n_code = bp.code.n
    hard, parity_ok, post_llr = bp.decode_full(llr.reshape(b * k_eff, n_code))
    hard = hard.reshape(b, k_eff, n_code)
    parity_ok = parity_ok.reshape(b, k_eff)
    post_llr = post_llr.reshape(b, k_eff, n_code)
    n_payload, n_crc = crc_mat.shape
    payload = hard[:, :, :n_payload].astype(jnp.float32)
    crc_calc = jnp.mod(jnp.einsum("bkp,pc->bkc", payload, crc_mat,
                                  preferred_element_type=jnp.float32), 2.0)
    crc_ok = jnp.all(
        jnp.abs(crc_calc - hard[:, :, n_payload : n_payload + n_crc]) < 0.5,
        axis=-1,
    )
    # guard against the trivial all-zero codeword: a silent window yields
    # zero LLRs, and all-zeros passes both parity and CRC — require real
    # demodulated evidence and a nonzero payload
    has_signal = jnp.sum(jnp.abs(llr), axis=-1) > 1e-3
    nonzero_payload = jnp.any(payload > 0.5, axis=-1)
    valid = parity_ok & crc_ok & has_signal & nonzero_payload & ~weak

    # --- 5b. OSD fallback (deep decode) -------------------------------------
    # The reference's depth-3 decode gets its last ~1-1.5 dB from an
    # ordered-statistics pass when BP fails (see modes/osd.py). Run it on
    # the osd_j strongest sync candidates that BP could not validate.
    if spec.osd_j > 0:
        from cwsl_digi_tpu.modes.osd import flip_patterns, osd_decode

        j = min(spec.osd_j, k_eff)
        no_osd = weak | (nsync <= spec.osd_sync_min)
        prio = jnp.where(valid | no_osd, -jnp.inf, top_val)
        _, sel = jax.lax.top_k(prio, j)                       # [b, j]
        bidx = jnp.arange(b)[:, None]
        # BP posterior LLRs: reliability ordering sharpened by the checks
        # that did converge (BP-OSD); metric weights stay the channel LLRs.
        sel_post = post_llr[bidx, sel]                        # [b, j, n]
        sel_chan = llr.reshape(b, k_eff, n_code)[bidx, sel]
        gen = np.concatenate(
            [np.eye(bp.code.k, dtype=np.uint8), bp.code.gen_parity], axis=1)
        pats = flip_patterns(bp.code.k, spec.osd_singles,
                             spec.osd_tail2, spec.osd_tail3).astype(np.float32)
        osd_in = sel_post if spec.osd_post else sel_chan
        osd_cw, osd_dist, osd_nhard = osd_decode(
            gen, osd_in.reshape(b * j, n_code), pats)
        osd_cw = osd_cw.reshape(b, j, n_code)
        osd_dist = osd_dist.reshape(b, j)
        osd_nhard = osd_nhard.reshape(b, j)
        # acceptance gates (CRC + plausibility; calibrated on noise windows)
        osd_payload = osd_cw[:, :, :n_payload].astype(jnp.float32)
        osd_crc = jnp.mod(jnp.einsum("bkp,pc->bkc", osd_payload, crc_mat,
                                     preferred_element_type=jnp.float32), 2.0)
        osd_crc_ok = jnp.all(
            jnp.abs(osd_crc - osd_cw[:, :, n_payload:n_payload + n_crc]) < 0.5,
            axis=-1)
        # the distance budget counts only the bits the channel decided: an
        # a-priori hypothesis's forced bits (|LLR| 50) would inflate it
        # several-fold over its noise calibration
        free = 1.0 if ap_mask is None else jnp.tile(
            1.0 - ap_mask, (spec.top_k, 1))[sel]
        wsum = jnp.sum(jnp.abs(sel_chan) * free, axis=-1)
        osd_ok = (
            osd_crc_ok
            & (osd_nhard <= spec.osd_nhard_max)
            & (osd_dist <= spec.osd_dist_frac * wsum)
            & jnp.any(osd_payload > 0.5, axis=-1)
            & (wsum > 1e-3)
        )
        # merge: only previously-invalid, strong-sync slots were selected
        # (the others had -inf priority) — still, never overwrite a valid
        # slot nor accept a weak one
        was_valid = valid[bidx, sel]
        osd_ok = osd_ok & ~was_valid & ~no_osd[bidx, sel]
        new_hard = jnp.where(osd_ok[:, :, None], osd_cw, hard[bidx, sel])
        hard = hard.at[bidx, sel].set(new_hard)
        valid = valid.at[bidx, sel].set(was_valid | osd_ok)

    return {
        "valid": valid,
        "payload": hard[:, :, : n_payload + n_crc],
        "t0_hop": t0 - spec.pad_hops,
        "f0_bin": f0 + fmin_bin,
        "score": top_val,
        "snr": snr,
    }


@functools.partial(jax.jit, static_argnums=(0,))
def select_subtract_params(m_max: int, payload, valid, score, t0_hop,
                           f0_bin, hash_w):
    """Device-side pick of up to ``m_max`` unique valid decodes per window.

    Replaces the host argwhere+dict loop between subtraction passes (which
    cost a full device->host fetch per pass).
    Uniqueness is by a 31-bit payload hash (collision odds ~K^2/2^32 per
    window — a collision only skips one burst's subtraction); ties keep the
    highest sync score, matching the host path's best-duplicate rule.

    Returns the packed int32 params tensor subtract_known consumes:
    [B, m_max, n_info + 3] = [info bits | t0_hop | f0_bin | valid].
    """
    b = payload.shape[0]
    info = payload.astype(jnp.int32)
    h = jnp.einsum("bki,i->bk", info, hash_w,
                   preferred_element_type=jnp.int32)
    key_h = jnp.where(valid, h, jnp.iinfo(jnp.int32).max)
    # stable two-key sort: hash ascending, then score descending
    order = jnp.lexsort((-score, key_h), axis=-1)
    hs = jnp.take_along_axis(key_h, order, axis=-1)
    vs = jnp.take_along_axis(valid, order, axis=-1)
    ss = jnp.take_along_axis(score, order, axis=-1)
    first = jnp.concatenate(
        [jnp.ones((b, 1), bool), hs[:, 1:] != hs[:, :-1]], axis=1)
    uniq = vs & first
    _, sel = jax.lax.top_k(jnp.where(uniq, ss, -jnp.inf), m_max)
    idx = jnp.take_along_axis(order, sel, axis=-1)          # [b, m_max]
    okflag = jnp.take_along_axis(uniq, sel, axis=-1)
    gi = jnp.take_along_axis(info, idx[:, :, None], axis=1)
    gt = jnp.take_along_axis(t0_hop.astype(jnp.int32), idx, axis=1)
    gf = jnp.take_along_axis(f0_bin.astype(jnp.int32), idx, axis=1)
    return jnp.concatenate(
        [gi, gt[:, :, None], gf[:, :, None],
         okflag.astype(jnp.int32)[:, :, None]], axis=-1)


def _merge_outs(outs):
    if len(outs) == 1:
        return outs[0]
    return {key: jnp.concatenate([o[key] for o in outs], axis=1)
            for key in outs[0]}


@functools.partial(jax.jit, static_argnums=(0, 1))
def _select_and_subtract(spec, sub_max, audio, outs, hash_w, gen_parity):
    """One dispatch for merge + select + subtract between decode passes."""
    from cwsl_digi_tpu.modes.subtract import subtract_known

    merged = _merge_outs(outs)
    params = select_subtract_params(
        sub_max, merged["payload"], merged["valid"], merged["score"],
        merged["t0_hop"], merged["f0_bin"], hash_w)
    return subtract_known(spec, audio, params, gen_parity)


@jax.jit
def _merge_and_pack(outs):
    """One dispatch for the final merge + pack."""
    m = _merge_outs(outs)
    return _pack_outputs(m["valid"], m["payload"], m["t0_hop"],
                         m["f0_bin"], m["score"], m["snr"])


@jax.jit
def _pack_outputs(valid, payload, t0, f0, score, snr):
    """Pack decode outputs into one uint8 buffer [B, K, ceil(P/8)+10].

    Layout per (window, candidate): payload bits packed 8/byte, then
    [valid, t0+8192 (2B BE), f0 (3B BE), score*16 (2B BE, sat),
    (snr+64)*256 (2B BE, sat)].  Quantization: score 1/16 (ranking only),
    snr 1/256 dB — both far below their estimation noise.
    """
    b, k, p = payload.shape
    pad = (-p) % 8
    bits = payload.astype(jnp.float32)
    if pad:
        bits = jnp.concatenate(
            [bits, jnp.zeros((b, k, pad), jnp.float32)], axis=-1)
    w8 = jnp.asarray([128.0, 64.0, 32.0, 16.0, 8.0, 4.0, 2.0, 1.0])
    pay = (bits.reshape(b, k, -1, 8) @ w8).astype(jnp.uint8)

    def be(v, nbytes):
        v = v.astype(jnp.int32)
        return jnp.stack(
            [(v >> (8 * (nbytes - 1 - i))) & 0xFF for i in range(nbytes)],
            axis=-1)

    t0q = jnp.clip(t0.astype(jnp.int32) + 8192, 0, 65535)
    f0q = jnp.clip(f0.astype(jnp.int32), 0, (1 << 24) - 1)
    sq = jnp.clip(score * 16.0, 0.0, 65535.0).astype(jnp.int32)
    nq = jnp.clip((snr + 64.0) * 256.0, 0.0, 65535.0).astype(jnp.int32)
    meta = jnp.concatenate(
        [valid.astype(jnp.int32)[..., None], be(t0q, 2), be(f0q, 3),
         be(sq, 2), be(nq, 2)], axis=-1).astype(jnp.uint8)
    return jnp.concatenate([pay, meta], axis=-1)


class GFSKDecoder:
    """Host wrapper shared by every sync-array GFSK mode.

    Subclasses (or instances) provide the mode spec, the LDPC decoder, the
    payload CRC matrix, and an ``unpack(payload_bits) -> text | None`` hook
    (None: a payload no decoder reports, e.g. an unsupported type).
    """

    def __init__(self, spec: ModeSpec, bp: BPDecoder, crc_matrix: np.ndarray,
                 mode, unpack,
                 ap_hypotheses: np.ndarray | None = None) -> None:
        if spec.depth <= 1 and spec.osd_j:
            # depth 1 ≙ jt9 -d 1 "fast": BP only, no OSD pass
            spec = dataclasses.replace(spec, osd_j=0)
        self.spec = spec
        self.bp = bp
        self.mode = mode
        self.unpack = unpack
        self._crc_mat = crc_matrix.astype(np.float32)
        self._bitmaps = spec.bitmaps()
        self._window = np.hanning(spec.sps).astype(np.float32)
        self._dft_mat = self._make_dft_mat()
        self._data_syms = np.asarray(spec.data_syms, np.int32)
        # a-priori hypotheses: [H, n_payload] with -1 = unknown, 0/1 = known
        self._ap_mask = None
        self._ap_vals = None
        if ap_hypotheses is not None and len(ap_hypotheses):
            hyp = np.asarray(ap_hypotheses)
            h = hyp.shape[0]
            mask = np.zeros((h, bp.code.n), np.float32)
            vals = np.zeros((h, bp.code.n), np.float32)
            mask[:, : hyp.shape[1]] = (hyp >= 0).astype(np.float32)
            vals[:, : hyp.shape[1]] = np.maximum(hyp, 0).astype(np.float32)
            self._ap_mask = mask
            self._ap_vals = vals
        # sanity: candidate grid must fit in the padded spectrogram (the
        # coherent demod gathers every symbol 0..n_sym-1 per candidate)
        n_samples = int(round(spec.trperiod * WAVE_SR))
        if spec.refine and self._dft_mat is not None:
            assert spec.hop % 2 == 0, (
                f"{spec.name}: refine needs an even hop ({spec.hop})")
        n_hops = (n_samples - spec.sps) // spec.hop + 1 + 2 * spec.pad_hops
        max_h = spec.max_hops + spec.os_t * (spec.n_sym - 1)
        assert max_h <= n_hops, (
            f"{spec.name}: sync search grid ({max_h}) exceeds spectrogram "
            f"hops ({n_hops}); reduce max_hops/pad_hops"
        )
        # per-window candidate working set: csym gather + cross tensors
        cand_bytes = spec.top_k * spec.n_sym * spec.n_tones * 8 * 3
        # sub-grid refinement keeps a second, half-hop demod spectrogram
        # resident (c64 at 2x hops): count it as 2x the hop budget
        n_hops_eff = 2 * n_hops if (spec.refine
                                    and self._dft_mat is not None) else n_hops
        self.max_device_batch = device_batch_for(
            n_hops_eff, spec.nfft, self.MAX_DEVICE_BATCH, cand_bytes)

    # Windows per device call: bounds spectrogram memory (a 15 s FT8 window
    # at the fine grid costs ~15 MB of device scratch per window).  Like
    # DEVICE_BYTES_BUDGET, not yet calibrated on the H100.
    MAX_DEVICE_BATCH = 64

    # largest DFT-as-matmul matrix worth materializing (f32 bytes); above
    # this (long FST4 variants) the rfft path is used.  Not yet calibrated
    # on the H100.
    DFT_MAT_BYTES_MAX = 128 << 20

    def _make_dft_mat(self) -> np.ndarray | None:
        """[sps, 4*n_bins] matrix computing boxcar+Hann DFTs over the kept
        bins in one matmul (see decode_program); None when the matrix
        would exceed DFT_MAT_BYTES_MAX (long FST4 modes -> rfft path)."""
        spec = self.spec
        fmin_bin = int(spec.fmin_hz / spec.bin_hz)
        fmax_bin = int(np.ceil(spec.fmax_hz / spec.bin_hz)) + 1
        n_bins = fmax_bin - fmin_bin + spec.os_f * spec.n_tones
        if spec.sps * 4 * n_bins * 4 > self.DFT_MAT_BYTES_MAX:
            return None
        k = fmin_bin + np.arange(n_bins)
        ang = -2.0 * np.pi * np.outer(np.arange(spec.sps), k) / spec.nfft
        dre, dim = np.cos(ang), np.sin(ang)
        w = self._window.astype(np.float64)[:, None]
        return np.concatenate(
            [dre, dim, w * dre, w * dim], axis=1).astype(np.float32)

    def decode_arrays(self, audio) -> dict[str, np.ndarray]:
        """Host-facing decode: ONE device->host fetch per device batch.

        The six output arrays are packed into a single uint8 buffer on
        device and split back here: one sync point instead of six.
        """
        return self._fetch_outputs(self.decode_arrays_device(audio))

    def _fetch_outputs(self, out) -> dict[str, np.ndarray]:
        """One packed device->host fetch of a device output dict."""
        packed = np.asarray(_pack_outputs(
            out["valid"], out["payload"], out["t0_hop"], out["f0_bin"],
            out["score"], out["snr"]))
        return self._parse_packed(packed, out["payload"].shape[-1])

    @staticmethod
    def _parse_packed(packed: np.ndarray, n_p: int) -> dict[str, np.ndarray]:
        """Split the packed uint8 buffer back into output arrays."""
        p8 = -(-n_p // 8)
        pay = np.unpackbits(packed[:, :, :p8], axis=-1)[:, :, :n_p]
        m = packed[:, :, p8:].astype(np.int64)
        return {
            "valid": m[:, :, 0] != 0,
            "payload": pay.astype(np.int8),
            "t0_hop": ((m[:, :, 1] << 8) | m[:, :, 2]) - 8192,
            "f0_bin": (m[:, :, 3] << 16) | (m[:, :, 4] << 8) | m[:, :, 5],
            "score": ((m[:, :, 6] << 8) | m[:, :, 7]).astype(np.float32)
            / 16.0,
            "snr": ((m[:, :, 8] << 8) | m[:, :, 9]).astype(np.float32)
            / 256.0 - 64.0,
        }

    def decode_arrays_device(self, audio,
                             spec: ModeSpec | None = None
                             ) -> dict[str, jax.Array]:
        """Run the decode program; audio may be host numpy OR device-resident
        (a residual from :func:`subtract.subtract_known`) — device audio is
        never round-tripped through the host."""
        spec = spec or self.spec
        if not isinstance(audio, jax.Array):
            audio = jnp.asarray(np.asarray(audio, dtype=np.float32))
        elif audio.dtype != jnp.float32:
            audio = audio.astype(jnp.float32)
        if audio.ndim == 1:
            audio = audio[None, :]
        n = audio.shape[0]
        batch = self.max_device_batch
        chunks = []
        for i in range(0, n, batch):
            chunk = audio[i : i + batch]
            c = chunk.shape[0]
            # bucket partial chunks to multiples of 8: bounds both compile
            # count AND wasted compute (the old pad-to-full-chunk rule made
            # a 24-window batch pay for max_device_batch=47 windows)
            cpad = min(batch, -(-c // 8) * 8)
            if cpad != c:
                chunk = jnp.concatenate(
                    [chunk, jnp.zeros((cpad - c, chunk.shape[1]),
                                      chunk.dtype)])
            program, args = self.device_call(chunk, spec)
            out = program(*args)
            chunks.append({k: v[:c] for k, v in out.items()})
        if len(chunks) == 1:
            return chunks[0]
        return {k: jnp.concatenate([c[k] for c in chunks])
                for k in chunks[0]}

    def device_call(self, chunk: jax.Array, spec: ModeSpec | None = None):
        """The jitted first-pass decode program and its arguments for one
        device chunk ``[B, N]``: ``program(*args)`` runs it and
        ``program.lower(*args)`` lowers it."""
        return decode_program, (
            spec or self.spec, (chunk.shape[1],), chunk, self._crc_mat,
            self._bitmaps, self._window, self.bp, self._data_syms,
            self._ap_mask, self._ap_vals, self._dft_mat_dev)

    def warm_passes(self, n_windows: int, depth: int | None = None) -> None:
        """Pre-compile every per-pass program arity :meth:`decode` can reach.

        The jitted inter-pass helpers (:func:`_select_and_subtract`,
        :func:`_merge_and_pack`) take a TUPLE of per-pass outputs, so each
        distinct number of executed passes is a distinct compiled program —
        and pass k only executes live when pass k-1 actually decoded
        something, a condition a single warmup window cannot force for
        every arity.  Left cold, the first crowded live window pays a
        mid-cadence XLA compile and misses its deadline.  Zeros audio is enough:
        program shape depends only on (n_windows, spec, arity).
        """
        depth = depth or self.spec.depth
        n = int(round(self.spec.trperiod * WAVE_SR))
        audio = jnp.zeros((n_windows, n), jnp.float32)
        outs = [self.decode_arrays_device(audio)]
        if depth > 1:
            later = self.decode_arrays_device(audio, self._later_pass_spec)
            for _p in range(1, depth):
                _select_and_subtract(self.spec, self.SUB_MAX, audio,
                                     tuple(outs), self._hash_w,
                                     self._gen_parity_f32)
                outs.append(later)
        last = None
        for k in range(1, len(outs) + 1):
            last = _merge_and_pack(tuple(outs[:k]))
        jax.block_until_ready(last)

    def decode(self, audio: np.ndarray, depth: int | None = None):
        """Decode with multi-pass signal subtraction.

        The reference's deep decode (``jt9 -d 3``) does iterative
        subtraction inside the external binary; here the ENTIRE depth loop
        runs on device: each pass decodes the residual after subtracting
        every already-decoded burst (selected and deduped on device,
        :func:`select_subtract_params`), and only the merged candidate set
        crosses back to the host — ONE fetch per decode() call instead of
        one per pass.
        """
        from cwsl_digi_tpu.modes.base import DecodeResult

        if isinstance(audio, jax.Array):
            # device-resident audio (e.g. straight from the channelizer):
            # no host round trip at all
            audio_dev = audio.astype(jnp.float32)
            if audio_dev.ndim == 1:
                audio_dev = audio_dev[None, :]
            n_windows = audio_dev.shape[0]
        else:
            audio = np.asarray(audio, dtype=np.float32)
            if audio.ndim == 1:
                audio = audio[None, :]
            n_windows = audio.shape[0]
            # upload ONCE, as peak-scaled int16 — exactly the audio format
            # the reference feeds jt9 (Instance::prepareAudio,
            # source/Instance.cpp:294-338).  Halves the upload vs f32, the
            # numpy cast vectorizes
            # (unlike f16), decode is per-window scale-invariant, and the
            # quantization floor sits ~45 dB under the window peak — below
            # the noise floor of any decodable signal.  Every later pass
            # rebuilds the residual on device from compact burst params
            # (modes/subtract.py) — no per-pass host synthesis/re-upload.
            # Passes stay separate dispatches, but nothing crosses back to
            # the host until the single packed fetch at the end.
            peak = np.abs(audio).max(axis=1, keepdims=True)
            scaled = (audio * (32000.0 / np.maximum(peak, 1e-30))
                      ).astype(np.int16)
            audio_dev = jnp.asarray(scaled).astype(jnp.float32)
        depth = depth or self.spec.depth
        spec = self.spec
        n_payload = self._crc_mat.shape[0]
        work = audio_dev
        outs: list[dict[str, jax.Array]] = []
        for _pass in range(max(1, depth)):
            # later passes search the residual AFTER the strong signals
            # are subtracted — few survivors remain, so a quarter of the
            # pass-1 candidate budget finds them at ~1/4 the device time
            # (jt9 -d3's subtraction passes likewise re-scan shallower)
            outs.append(self.decode_arrays_device(
                work, self._later_pass_spec if _pass else None))
            if _pass + 1 >= depth:
                break
            if not bool(np.asarray(jnp.any(outs[-1]["valid"]))):
                # EXACT early exit: zero decodes this pass means the
                # residual is unchanged, so the next pass would re-run the
                # identical program.  Costs one tiny sync; saves a full
                # pass + subtraction on quiet bands (most channels).
                break
            # rebuild the residual from the ORIGINAL audio, re-fitting every
            # known burst's gain now that more of the band is explained —
            # sequential refits over a cleaner residual give better
            # cancellation than one-shot subtraction in crowded bands
            work = _select_and_subtract(spec, self.SUB_MAX, audio_dev,
                                        tuple(outs), self._hash_w,
                                        self._gen_parity_f32)
        n_info = self._crc_mat.shape[0] + self._crc_mat.shape[1]
        out = self._parse_packed(
            np.asarray(_merge_and_pack(tuple(outs))), n_info)

        # sparse iteration: decodes only (the K axis can be 512+ per
        # window, with a handful of valid entries).  Dedup BEFORE message
        # unpacking: passes and OSD produce many duplicate valid slots per
        # signal, and unpack is the expensive host step (~60 us each;
        # deduping first cuts busy-band host time ~13x).
        seen: list[dict[bytes, tuple[float, int]]] = [
            dict() for _ in range(n_windows)]
        for wi, k in np.argwhere(out["valid"]):
            key = np.packbits(
                out["payload"][wi, k, :n_payload].astype(np.uint8)).tobytes()
            score = float(out["score"][wi, k])
            prev = seen[wi].get(key)
            if prev is None or score > prev[0]:
                seen[wi][key] = (score, int(k))
        results = []
        for wi in range(n_windows):
            rs = []
            for score, k in seen[wi].values():
                payload = np.asarray(out["payload"][wi, k, :n_payload])
                text = self.unpack(payload)
                if text is None:
                    continue            # a message type no decoder reports
                dt = out["t0_hop"][wi, k] * spec.hop / WAVE_SR \
                    - spec.signal_start_s
                freq = out["f0_bin"][wi, k] * spec.bin_hz
                rs.append(DecodeResult(
                    message=text,
                    snr_db=round(float(out["snr"][wi, k]), 1),
                    dt_s=round(float(dt), 2),
                    freq_hz=round(float(freq), 1),
                    score=score,
                    mode=self.mode,
                    payload_bits=payload.copy(),
                ))
            results.append(sorted(rs, key=lambda r: -r.score))
        return results

    # most known bursts subtractable per window (crowded-band headroom;
    # beyond this, the strongest bursts are kept).  Each burst is one step
    # of the sequential device scan (~10 ms per step at FT8 size), so this
    # trades tail-of-pileup recall against decode latency.
    SUB_MAX = 16

    @functools.cached_property
    def _later_pass_spec(self) -> "ModeSpec":
        # half the pass-1 budget: //4 measurably lost ~0.2 busy-band
        # decodes/window; //2 matched full-K recall at half the cost
        return dataclasses.replace(
            self.spec, top_k=min(self.spec.top_k, max(128, self.spec.top_k // 2)))

    @functools.cached_property
    def _hash_w(self) -> jax.Array:
        """Random int32 weights hashing payloads in select_subtract_params."""
        rng = np.random.default_rng(0x5D1F)
        n_info = self._crc_mat.shape[0] + self._crc_mat.shape[1]
        return jnp.asarray(
            rng.integers(1, 2**31 - 1, size=n_info, dtype=np.int32))

    @functools.cached_property
    def _gen_parity_f32(self) -> np.ndarray:
        return np.asarray(self.bp.code.gen_parity, np.float32)

    @functools.cached_property
    def _dft_mat_dev(self) -> jax.Array | None:
        # uploaded ONCE: as a numpy argument it would re-transfer its
        # tens of MB on every decode_program call
        return None if self._dft_mat is None else jnp.asarray(self._dft_mat)

    def _subtract(self, audio: np.ndarray, info: np.ndarray,
                  t0_hop: int, f0_bin: int) -> None:
        """Subtract one decoded burst in place (host oracle; the production
        path is the device scan in :mod:`cwsl_digi_tpu.modes.subtract`).

        Joint (df, dt) refinement from per-symbol correlation pair phases:
        same-tone pairs see only 2*pi*df*T_sym (time error cancels since
        both symbols sit on the same frequency), tone-change pairs see
        2*pi*spacing*dtone*dt once df is removed.  The gain is then fitted
        per symbol and smoothed over GAIN_SMOOTH_SYMS symbols (wsjt-x
        subtractft8's low-passed complex amplitude): the df estimators are
        noise-limited to ~0.05 Hz, which decoheres a single global gain
        over a full burst (see modes/subtract.py docstring for the
        measured failure), while a raw 1-symbol gain would soak
        overlapping other signals — the smoothing window is the
        compromise that tracks residual drift without absorbing
        neighbors.
        """
        from cwsl_digi_tpu.modes.gfsk import gfsk_modulate_iq

        spec = self.spec
        codeword = self.bp.code.encode(np.asarray(info[: self.bp.code.k]))
        tones = spec.tones_from_codeword(codeword)
        f0 = f0_bin * spec.bin_hz
        sps = spec.sps
        start = t0_hop * spec.hop
        z0 = gfsk_modulate_iq(tones, f0, sps, WAVE_SR,
                              spec.tone_spacing, bt=spec.bt)
        L = len(z0)
        n = np.arange(L)
        dtone = np.asarray(tones[1:]) - np.asarray(tones[:-1])
        same = dtone == 0
        sel = (np.abs(dtone) >= 1) & (np.abs(dtone) <= 3)
        df_tot = 0.0

        def corr(start, df_tot):
            zc = z0 * np.exp(1j * 2.0 * np.pi * df_tot / WAVE_SR * n)
            pos = start + n
            inb = (pos >= 0) & (pos < len(audio))
            seg = np.where(inb, audio[np.clip(pos, 0, len(audio) - 1)], 0.0)
            c = (seg.reshape(-1, sps) * np.conj(zc.reshape(-1, sps))).sum(1)
            return seg, inb, zc, c

        # schedule matches the device scan (modes/subtract.py): df1 from
        # same-tone pairs, dt from tone-change pairs (df1 removed
        # analytically), re-extract at the shifted start, df2 touch-up.
        _, _, _, c = corr(start, df_tot)
        p = c[1:] * np.conj(c[:-1])
        if same.any():
            df = np.angle(np.sum(p * same)) / (2.0 * np.pi * sps / WAVE_SR)
            if abs(df) < spec.bin_hz:
                df_tot += df
        th = np.angle(p * np.exp(-2j * np.pi * df_tot * sps / WAVE_SR))
        w = np.abs(p) * sel
        den = 2.0 * np.pi * spec.tone_spacing * np.sum(w * dtone * dtone)
        if den > 0:
            dt = np.sum(w * th * dtone) / den
            start -= int(np.clip(round(dt * WAVE_SR), -(sps - 1), sps - 1))
        _, _, _, c = corr(start, df_tot)
        p = c[1:] * np.conj(c[:-1])
        if same.any():
            df = np.angle(np.sum(p * same)) / (2.0 * np.pi * sps / WAVE_SR)
            if abs(df) < spec.bin_hz:
                df_tot += df

        seg, inb, zc, c = corr(start, df_tot)
        if inb.sum() <= 0:
            return
        from cwsl_digi_tpu.modes.subtract import GAIN_SMOOTH_SYMS

        cnt = inb.reshape(-1, sps).sum(1).astype(np.float64)
        kern = np.ones(GAIN_SMOOTH_SYMS)
        num = np.convolve(c, kern, mode="same")
        den = np.maximum(np.convolve(cnt, kern, mode="same"), 1.0)
        g = 2.0 * num / den                       # [n_sym] complex gain
        sub = np.real(np.repeat(g, sps) * zc) * inb
        pos = np.clip(start + n, 0, len(audio) - 1)
        np.subtract.at(audio, pos, sub.astype(np.float32))
