"""Generic batched decoder engine for q-ary single-tone-per-symbol modes
(JT65, Q65): sync tone at known symbol positions, data symbols carrying one
GF(64) value as a tone index.

Device side: spectrogram, sync-tone correlation over (t0, f0), top-K
candidates, per-symbol tone-energy gather -> best/second-best values and
margins.  Host side: Reed-Solomon errors-and-erasures decoding with a
progressive erasure schedule on the least-confident symbols (the native
stand-in for the Koetter-Vardy style soft decoding the external jt9 uses).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from cwsl_digi_tpu.constants import WAVE_SR


@dataclasses.dataclass(frozen=True)
class QarySpec:
    name: str
    n_sym: int
    sps: int
    n_tones: int                 # data alphabet size (64)
    tone_offset: int             # data tone index of value 0 (in tone steps)
    sync_syms: tuple[int, ...]   # symbol indices carrying the sync tone (0)
    data_syms: tuple[int, ...]
    trperiod: float
    signal_start_s: float = 0.5
    fmin_hz: float = 200.0
    fmax_hz: float = 2700.0
    top_k: int = 32
    max_hops: int = 96
    pad_hops: int = 48
    os_t: int = 8                # hops per symbol (time oversampling)
    os_f: int = 4                # nfft / sps (freq oversampling; tone = os_f bins)
    full_e: bool = False         # also return full per-tone energies (for
                                 # the q-ary message-passing decode path)
    snr_offset_db: float = 0.0   # per-mode SNR calibration (tools/snr_check)

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
    def tone_spacing(self) -> float:
        return WAVE_SR / self.sps


@functools.partial(jax.jit, static_argnums=(0, 1))
def qary_decode_program(spec: QarySpec, shapes, audio, window,
                        data_syms, sync_syms, dft_mat=None):
    (n_samples,) = shapes
    b = audio.shape[0]
    sps, hop, nfft = spec.sps, spec.hop, spec.nfft
    n_hops = (n_samples - sps) // hop + 1
    fmin_bin = int(spec.fmin_hz / spec.bin_hz)
    fmax_bin = int(spec.fmax_hz / spec.bin_hz)
    # headroom for the highest data tone
    n_bins = fmax_bin - fmin_bin + spec.os_f * (spec.tone_offset + spec.n_tones)

    # two windows: tapered for sync, boxcar (matched) for symbol demod —
    # same rationale as gfsk_engine.decode_program
    idx = jnp.arange(n_hops)[:, None] * hop + jnp.arange(sps)[None, :]
    frames = audio[:, idx]

    if dft_mat is not None:
        # DFT as a matmul over only the kept bins (as in gfsk_engine):
        # bf16 in, f32 accumulate; columns are
        # [box_re, box_im, hann_re, hann_im].
        four = jnp.einsum(
            "is,sj->ij",
            frames.reshape(b * n_hops, sps).astype(jnp.bfloat16),
            dft_mat.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32)
        four = four.reshape(b, n_hops, 4, n_bins)
        pad = ((0, 0), (spec.pad_hops, spec.pad_hops), (0, 0))
        power_sync = jnp.pad(four[:, :, 2] ** 2 + four[:, :, 3] ** 2, pad)
        power = jnp.pad(four[:, :, 0] ** 2 + four[:, :, 1] ** 2, pad)
    else:
        def spectrogram(w):
            p = jnp.abs(jnp.fft.rfft(frames * w[None, None, :], n=nfft,
                                     axis=-1)) ** 2
            p = p[:, :, fmin_bin : fmin_bin + n_bins]
            return jnp.pad(p, ((0, 0), (spec.pad_hops, spec.pad_hops),
                               (0, 0)))

        power_sync = spectrogram(window)
        power = spectrogram(jnp.ones((sps,), jnp.float32))

    # sync correlation at tone 0
    n_t0 = spec.max_hops
    n_f0 = fmax_bin - fmin_bin
    acc = jnp.zeros((b, n_t0, n_f0), jnp.float32)
    for s in spec.sync_syms:
        h0 = spec.os_t * s
        acc = acc + jax.lax.slice(power_sync, (0, h0, 0), (b, h0 + n_t0, n_f0))
    base = jnp.mean(power_sync, axis=(1, 2), keepdims=True) * len(spec.sync_syms)
    score = acc / (base + 1e-30)

    flat = score.reshape(b, -1)
    top_val, top_idx = jax.lax.top_k(flat, spec.top_k)
    t0 = top_idx // n_f0
    f0 = top_idx % n_f0

    # data-symbol tone energies
    sym_hops = t0[:, :, None] + spec.os_t * data_syms[None, None, :]
    tone_bins = (f0[:, :, None]
                 + spec.os_f * (spec.tone_offset
                        + jnp.arange(spec.n_tones, dtype=jnp.int32))[None, None, :])
    bb = jnp.arange(b)[:, None, None, None]
    e = power[bb, sym_hops[:, :, :, None], tone_bins[:, :, None, :]]
    # top-4 tone hypotheses per symbol (compact soft information for the
    # host-side list decoder) + total energy for noise normalization
    top_e, top_tone = jax.lax.top_k(e, 4)                   # [B, K, n_data, 4]
    e_sum = jnp.sum(e, axis=-1)                             # [B, K, n_data]
    margin = (jnp.log(top_e[..., 0] + 1e-30)
              - jnp.log(top_e[..., 1] + 1e-30))

    noise = jnp.median(power_sync, axis=(1, 2))
    sig = top_val * base[:, :, 0] / len(spec.sync_syms)
    snr = 10.0 * jnp.log10((sig + 1e-30) / (noise[:, None] + 1e-30)) \
        - 10.0 * np.float32(np.log10(2500.0 / spec.tone_spacing)) \
        + np.float32(spec.snr_offset_db)

    out = {
        "symbols": top_tone[..., 0].astype(jnp.int32),  # hard GF(64) values
        "margin": margin,         # [B, K, n_data] log-energy margins
        "top_e": top_e,           # [B, K, n_data, 4] top tone energies
        "top_tone": top_tone.astype(jnp.int32),
        "e_sum": e_sum,           # [B, K, n_data] per-symbol total energy
        "score": top_val,
        "t0_hop": t0 - spec.pad_hops,
        "f0_bin": f0 + fmin_bin,
        "snr": snr,
    }
    if spec.full_e:
        out["e"] = e              # [B, K, n_data, n_tones]
    return out


@functools.partial(jax.jit, static_argnums=(0,))
def _mp_priors(variants: tuple, e: jax.Array) -> jax.Array:
    """Per-tone energies [B, K, n, T] -> prior variants [B, K, V, n, T].

    Noncoherent channel likelihoods: noise energy per bin is exponential
    with mean N0; median(e)/ln2 estimates N0 robustly.  gamma<1 flattens
    (robust to N0 overestimate), gamma>1 sharpens; n_erase replaces the
    least-confident symbols' priors with uniform (Chase-style retry).
    """
    bsz, top_k, n_data, n_tones = e.shape
    med = jnp.median(e.reshape(bsz, top_k, -1), axis=-1)[:, :, None, None]
    n0 = jnp.maximum(med / np.log(2.0), 1e-30)
    x = e / n0
    x = x - x.max(axis=-1, keepdims=True)
    x = jnp.maximum(x, -40.0)
    xs = jnp.sort(x, axis=-1)
    sym_margin = xs[..., -1] - xs[..., -2]             # [B, K, n]
    rank = jnp.argsort(jnp.argsort(sym_margin, axis=-1), axis=-1)

    outs = []
    for gamma, n_erase in variants:
        p = jax.nn.softmax(gamma * x, axis=-1)
        if n_erase:
            p = jnp.where((rank < n_erase)[..., None],
                          jnp.float32(1.0 / n_tones), p)
        outs.append(p)
    return jnp.stack(outs, axis=2)                     # [B, K, V, n, T]


@jax.jit
def _mp_score_pack(accept: float, e, hard, ok, score, t0, f0, snr):
    """Re-encode scoring + best-variant selection + output packing.

    s_v = mean_s log(e[s, cw_v[s]] / mean_s e) per variant; among
    converging variants above ``accept`` the best wins.  Returns
    [B, K, n + 5] float32: codeword | ok | score | t0 | f0 | snr.
    """
    bsz, top_k, n_data, n_tones = e.shape
    e_cw = jnp.take_along_axis(
        e[:, :, None], hard[..., None], axis=-1)[..., 0]   # [B, K, V, n]
    mean_e = jnp.mean(e, axis=-1)[:, :, None, :]
    s = jnp.mean(jnp.log((e_cw + 1e-30) / (mean_e + 1e-30)), axis=-1)
    s = jnp.where(ok & (s >= accept), s, -jnp.inf)         # [B, K, V]
    best = jnp.argmax(s, axis=-1)                          # [B, K]
    bb = jnp.arange(bsz)[:, None]
    kk = jnp.arange(top_k)[None, :]
    cw = hard[bb, kk, best]                                # [B, K, n]
    okf = jnp.isfinite(s[bb, kk, best])
    return jnp.concatenate([
        cw.astype(jnp.float32), okf[:, :, None].astype(jnp.float32),
        score[:, :, None], t0[:, :, None].astype(jnp.float32),
        f0[:, :, None].astype(jnp.float32), snr[:, :, None]], axis=-1)


# progressive erasure schedule: erase the f least-confident symbols
ERASURE_SCHEDULE = (0, 8, 16, 24, 32, 40)


class QaryDecoder:
    """Host wrapper: device symbol demod + host RS errors-and-erasures.

    Decoding tiers per candidate (the native substitute for the soft
    Koetter-Vardy / Franke-Taylor decoding inside jt9):
    1. deterministic progressive-erasure schedule (cheap);
    2. stochastic Chase: random erasure patterns biased toward
       low-confidence symbols, with deep erasure counts — applied to the
       best ``chase_top`` sync candidates only.

    Acceptance is a *soft* re-encode score, not hard-symbol agreement: the
    re-encoded codeword's tone energies are summed over all n symbols
    (normalized by the per-symbol mean energy).  Erased positions act as
    independent verification — a wrong codeword scores ~0 there while a
    true decode at threshold scores ~log(1+Es/N0) per symbol — so erasure
    counts close to n-k stay safe (the FT-style deep-decode trick).
    """

    def __init__(self, spec: QarySpec, rs, mode, unpack, min_score: float = 1.5,
                 chase_trials: int = 150, chase_top: int = 4,
                 soft_accept: float = 0.40, native_trials: int = 10_000,
                 mp=None, symbol_perm=None, value_demap=None,
                 device_rs: bool = True, device_trials: int = 256):
        self.spec = spec
        self.rs = rs
        self.mp = mp                  # QaryMPDecoder (q-ary sum-product path)
        self.mode = mode
        self.unpack = unpack          # (info_symbols) -> text or None
        # channel-domain -> codeword-domain transform (JT65: deinterleave +
        # inverse Gray code).  symbol_perm[s] = transmitted data-symbol
        # position of codeword symbol s; value_demap[tone_value] = GF value.
        self.symbol_perm = (None if symbol_perm is None
                            else np.asarray(symbol_perm, np.int64))
        self.value_demap = (None if value_demap is None
                            else np.asarray(value_demap, np.int64))
        self.min_score = min_score
        self.chase_trials = chase_trials
        self.chase_top = chase_top
        self.soft_accept = soft_accept
        self.native_trials = native_trials
        self._window = np.hanning(spec.sps).astype(np.float32)
        self._data_syms = np.asarray(spec.data_syms, np.int32)
        self._sync_syms = np.asarray(spec.sync_syms, np.int32)
        # batched DEVICE RS errors-and-erasures chase (modes/rs_device.py):
        # every (candidate x erasure pattern) trial decodes in parallel on
        # device, retiring the host FEC bottleneck.  mp modes (Q65) keep their
        # device sum-product path.
        self.device_rs = bool(device_rs) and mp is None
        self.device_trials = device_trials
        # native FT trial loop (native/rs_ft.cpp); None -> pure-Python tiers
        try:
            from cwsl_digi_tpu import native as _native

            _native.load()
            self._native_ft = _native.rs_ft_decode
        except Exception:
            self._native_ft = None

    def _soft_score(self, cw: np.ndarray, top_e: np.ndarray,
                    top_tone: np.ndarray, e_sum: np.ndarray) -> float:
        """Mean over symbols of log(E[cw tone] / mean symbol energy).

        Noise gives ~-0.1; a true codeword at the decode threshold gives
        >0.5.  Tones outside the stored top-4 get the mean residual energy.
        """
        n_tones = self.spec.n_tones
        hit = top_tone == cw[:, None]                      # [n, 4]
        e_top_sum = top_e.sum(axis=1)
        floor = (e_sum - e_top_sum) / (n_tones - 4)
        e_cw = np.where(hit.any(axis=1),
                        (top_e * hit).sum(axis=1), floor)
        mean_e = e_sum / n_tones
        return float(np.mean(np.log((e_cw + 1e-30) / (mean_e + 1e-30))))

    def decode_arrays_device(self, audio) -> dict:
        """Device demod; returns DEVICE-resident output arrays."""
        import jax.numpy as jnp

        if not isinstance(audio, jax.Array):
            audio = jnp.asarray(np.asarray(audio, np.float32))
        elif audio.dtype != jnp.float32:
            audio = audio.astype(jnp.float32)
        if audio.ndim == 1:
            audio = audio[None, :]
        n = audio.shape[0]
        batch = self._max_device_batch(audio.shape[1])
        if n > batch and (-n) % batch:
            audio = jnp.concatenate(
                [audio, jnp.zeros(((-n) % batch, audio.shape[1]),
                                  jnp.float32)])
        chunks = []
        for i in range(0, audio.shape[0], batch):
            program, args = self.device_call(audio[i : i + batch])
            chunks.append(program(*args))
        if len(chunks) == 1:
            return {k: v[:n] for k, v in chunks[0].items()}
        return {k: jnp.concatenate([c[k] for c in chunks])[:n]
                for k in chunks[0]}

    def device_call(self, chunk):
        """The jitted decode program and its arguments for one device
        chunk ``[B, N]`` (``program.lower(*args)`` lowers it)."""
        return qary_decode_program, (
            self.spec, (chunk.shape[1],), chunk, self._window,
            self._data_syms, self._sync_syms, self._dft_mat_dev)

    def decode_arrays(self, audio: np.ndarray) -> dict[str, np.ndarray]:
        return {k: np.asarray(v)
                for k, v in self.decode_arrays_device(audio).items()}

    @functools.cached_property
    def max_device_batch(self) -> int:
        """Windows per device call at this mode's T/R (bench/runtime)."""
        n = int(round(self.spec.trperiod * WAVE_SR))
        return self._max_device_batch(n)

    # largest DFT-as-matmul matrix worth materializing (f32 bytes)
    DFT_MAT_BYTES_MAX = 256 << 20

    @functools.cached_property
    def _dft_mat(self) -> np.ndarray | None:
        """[sps, 4*n_bins] boxcar+Hann DFT matrix over the kept bins."""
        spec = self.spec
        fmin_bin = int(spec.fmin_hz / spec.bin_hz)
        fmax_bin = int(spec.fmax_hz / spec.bin_hz)
        n_bins = (fmax_bin - fmin_bin
                  + spec.os_f * (spec.tone_offset + spec.n_tones))
        if spec.sps * 4 * n_bins * 4 > self.DFT_MAT_BYTES_MAX:
            return None
        kk = fmin_bin + np.arange(n_bins)
        ang = -2.0 * np.pi * np.outer(np.arange(spec.sps), kk) / spec.nfft
        dre, dim = np.cos(ang), np.sin(ang)
        w = self._window.astype(np.float64)[:, None]
        return np.concatenate([dre, dim, w * dre, w * dim],
                              axis=1).astype(np.float32)

    @functools.cached_property
    def _dft_mat_dev(self):
        import jax.numpy as jnp

        return None if self._dft_mat is None else jnp.asarray(self._dft_mat)

    def _max_device_batch(self, n_samples: int) -> int:
        from cwsl_digi_tpu.modes.gfsk_engine import device_batch_for

        n_hops = ((n_samples - self.spec.sps) // self.spec.hop + 1
                  + 2 * self.spec.pad_hops)
        return device_batch_for(n_hops, self.spec.nfft, 64)

    def decode(self, audio: np.ndarray):
        from cwsl_digi_tpu.modes.base import DecodeResult

        if not isinstance(audio, jax.Array):
            audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = audio[None, :]
        if self.mp is not None:
            return self._decode_mp(self.decode_arrays_device(audio))
        if self.device_rs:
            return self._decode_device_rs(audio)
        out = self.decode_arrays(audio)
        spec = self.spec
        results = []
        for wi in range(audio.shape[0]):
            seen: dict[bytes, DecodeResult] = {}
            for k in range(spec.top_k):
                if out["score"][wi, k] < self.min_score:
                    continue
                syms = out["symbols"][wi, k].astype(np.int64)
                margin = out["margin"][wi, k]
                top_e = out["top_e"][wi, k]
                top_tone = out["top_tone"][wi, k].astype(np.int64)
                e_sum = out["e_sum"][wi, k]
                if self.symbol_perm is not None:
                    p = self.symbol_perm
                    syms, margin = syms[p], margin[p]
                    top_e, top_tone, e_sum = top_e[p], top_tone[p], e_sum[p]
                if self.value_demap is not None:
                    syms = self.value_demap[syms]
                    top_tone = self.value_demap[top_tone]

                def accept(info):
                    if info is None:
                        return None
                    cw = self.rs.encode(info)
                    s = self._soft_score(cw, top_e, top_tone, e_sum)
                    return s if s >= self.soft_accept else None

                info = None
                if self._native_ft is not None:
                    # native FT loop runs the deterministic schedule + deep
                    # stochastic trials in one call
                    trials = (self.native_trials if k < self.chase_top
                              else self.native_trials // 20)
                    hit = self._native_ft(
                        self.rs.k, syms, margin, top_e, top_tone, e_sum,
                        spec.n_tones, trials, wi * 7919 + k + 1,
                        self.soft_accept, fcr=getattr(self.rs, "fcr", 1))
                    if hit is not None:
                        info = hit[0]
                else:
                    order = np.argsort(margin)      # least confident first
                    for f in ERASURE_SCHEDULE:
                        if f > self.rs.n_parity:
                            break
                        erasures = list(map(int, order[:f]))
                        cand = self.rs.decode(syms.copy(), erasures=erasures)
                        if accept(cand) is not None:
                            info = cand
                            break
                    if info is None and k < self.chase_top:
                        info = self._chase(syms, margin, accept,
                                           seed=wi * 1000 + k)
                if info is None:
                    continue
                text = self.unpack(np.asarray(info))
                if text is None:
                    continue
                key = bytes(np.asarray(info, np.uint8))
                dt = out["t0_hop"][wi, k] * spec.hop / WAVE_SR - spec.signal_start_s
                freq = out["f0_bin"][wi, k] * spec.bin_hz
                r = DecodeResult(
                    message=text,
                    snr_db=round(float(out["snr"][wi, k]), 1),
                    dt_s=round(float(dt), 2),
                    freq_hz=round(float(freq), 1),
                    score=float(out["score"][wi, k]),
                    mode=self.mode,
                    payload_bits=np.asarray(info, np.uint8),
                )
                prev = seen.get(key)
                if prev is None or r.score > prev.score:
                    seen[key] = r
            results.append(sorted(seen.values(), key=lambda r: -r.score))
        return results

    def _decode_device_rs(self, audio) -> list:
        """Fully device-chained decode: demod -> perm/demap -> batched RS
        chase run back-to-back on device; ONE small packed fetch (accepted
        info + per-candidate metadata) returns to the host."""
        import jax.numpy as jnp

        from cwsl_digi_tpu.modes.base import DecodeResult
        from cwsl_digi_tpu.modes.rs_device import rs_chase_program

        spec = self.spec
        n_windows = audio.shape[0]
        out = self.decode_arrays_device(audio)
        bsz, top_k = out["score"].shape
        syms = out["symbols"].astype(jnp.int32)         # [B, K, n_data]
        margin = out["margin"]
        top_e = out["top_e"]
        top_tone = out["top_tone"].astype(jnp.int32)
        e_sum = out["e_sum"]
        if self.symbol_perm is not None:                # channel -> codeword
            p = jnp.asarray(self.symbol_perm, jnp.int32)
            syms = jnp.take(syms, p, axis=2)
            margin = jnp.take(margin, p, axis=2)
            top_e = jnp.take(top_e, p, axis=2)
            top_tone = jnp.take(top_tone, p, axis=2)
            e_sum = jnp.take(e_sum, p, axis=2)
        if self.value_demap is not None:
            dm = jnp.asarray(self.value_demap, jnp.int32)
            syms = jnp.take(dm, syms)
            top_tone = jnp.take(dm, top_tone)
        c = bsz * top_k
        n = syms.shape[-1]
        info, chase_score, chase_ok = rs_chase_program(
            (n, self.rs.k, getattr(self.rs, "fcr", 1)),
            self.device_trials, 6, self.soft_accept,
            syms.reshape(c, n), margin.reshape(c, n),
            top_e.reshape(c, n, -1), top_tone.reshape(c, n, -1),
            e_sum.reshape(c, n),
            jnp.sum(out["t0_hop"]).astype(jnp.int32) & 0x7FFFFFFF)
        # ONE packed fetch: info symbols + validity + candidate metadata
        packed = np.asarray(jnp.concatenate([
            info.reshape(bsz, top_k, -1).astype(jnp.float32),
            chase_ok.reshape(bsz, top_k, 1).astype(jnp.float32),
            out["score"][:, :, None],
            out["t0_hop"][:, :, None].astype(jnp.float32),
            out["f0_bin"][:, :, None].astype(jnp.float32),
            out["snr"][:, :, None],
            chase_score.reshape(bsz, top_k, 1),
        ], axis=-1))
        kk = self.rs.k
        info = packed[:, :, :kk].astype(np.int64)
        ok = packed[:, :, kk] > 0.5
        out = {"score": packed[:, :, kk + 1],
               "t0_hop": packed[:, :, kk + 2].astype(np.int64),
               "f0_bin": packed[:, :, kk + 3].astype(np.int64),
               "snr": packed[:, :, kk + 4]}
        soft = packed[:, :, kk + 5]
        results = []
        for wi in range(n_windows):
            seen: dict[bytes, tuple[DecodeResult, float]] = {}
            for k in range(top_k):
                if not ok[wi, k] or out["score"][wi, k] < self.min_score:
                    continue
                text = self.unpack(info[wi, k].astype(np.int64))
                if text is None:
                    continue
                key = bytes(info[wi, k].astype(np.uint8))
                dt = (out["t0_hop"][wi, k] * spec.hop / WAVE_SR
                      - spec.signal_start_s)
                freq = out["f0_bin"][wi, k] * spec.bin_hz
                r = DecodeResult(
                    message=text,
                    snr_db=round(float(out["snr"][wi, k]), 1),
                    dt_s=round(float(dt), 2),
                    freq_hz=round(float(freq), 1),
                    score=float(out["score"][wi, k]),
                    mode=self.mode,
                    payload_bits=info[wi, k].astype(np.uint8),
                )
                prev = seen.get(key)
                if prev is None or r.score > prev[0].score:
                    seen[key] = (r, float(soft[wi, k]))
            # one decode per signal: a strong signal read half a tone off
            # can yield a wrong codeword that still passes the soft accept
            # (two RS(63,12) codewords share up to 11 symbols, which at
            # high SNR alone outscore soft_accept); within one tone
            # spacing, keep the decode with the best soft score
            kept: list[DecodeResult] = []
            for r, _ in sorted(seen.values(), key=lambda rs: -rs[1]):
                if all(abs(r.freq_hz - q.freq_hz) >= spec.tone_spacing
                       for q in kept):
                    kept.append(r)
            results.append(sorted(kept, key=lambda r: -r.score))
        return results

    # prior variants for the MP retry ladder: (temperature, n_erase).
    # γ<1 flattens the likelihoods (robust to N0 overestimate), γ>1
    # sharpens them; n_erase>0 additionally replaces the least-confident
    # symbols' priors with uniform (a Chase-style erasure retry that lets
    # the code's redundancy fill unreliable positions instead of being
    # misled by them).
    MP_VARIANTS = ((1.0, 0), (0.7, 0), (1.35, 0), (1.0, 8), (0.7, 14))

    def _decode_mp(self, out: dict) -> list:
        """Q-ary sum-product decode path (Q65): full per-tone energies ->
        symbol likelihoods -> batched GF(64) message passing, ALL on
        device: prior prep, MP, and re-encode scoring chain into device
        programs and one small packed result returns.

        Each sync candidate is decoded under ``MP_VARIANTS`` prior
        variants (chunked so the message-passing working set
        [chunk, nc, mr, 64] stays inside the device budget); among
        converging variants the best soft re-encode score wins.
        Acceptance = zero syndrome + the soft re-encode score.
        """
        import jax.numpy as jnp

        from cwsl_digi_tpu.modes.base import DecodeResult

        spec = self.spec
        e = out["e"]                                   # [B, K, n_data, T]
        bsz, top_k, n_data, n_tones = e.shape
        n_var = len(self.MP_VARIANTS)
        flat = _mp_priors(self.MP_VARIANTS, e).reshape(
            bsz * top_k * n_var, n_data, n_tones)
        # chunk the MP fan-out: per-item working set is ~6 message arrays
        # of [nc, mr, 64] f32 (fwd/bwd permuted, WHT temps, extrinsics)
        nc, mr = self.mp.code.h_vars.shape
        per_item = nc * mr * 64 * 4 * 6
        from cwsl_digi_tpu.modes.gfsk_engine import DEVICE_BYTES_BUDGET

        mp_batch = max(1, min(len(flat), DEVICE_BYTES_BUDGET // per_item))
        hards, oks = [], []
        for i in range(0, len(flat), mp_batch):
            chunk = flat[i : i + mp_batch]
            if len(chunk) < mp_batch:  # pad tail: one compiled shape
                chunk = jnp.concatenate([
                    chunk,
                    jnp.full((mp_batch - len(chunk), n_data, n_tones),
                             1.0 / n_tones, jnp.float32)])
            h, o, _conf = self.mp.decode(chunk)
            hards.append(h)
            oks.append(o)
        hard = jnp.concatenate(hards)[: len(flat)].reshape(
            bsz, top_k, n_var, n_data)
        ok = jnp.concatenate(oks)[: len(flat)].reshape(bsz, top_k, n_var)

        # device scoring + variant selection + ONE packed fetch
        packed = np.asarray(_mp_score_pack(
            self.soft_accept, e, hard, ok, out["score"], out["t0_hop"],
            out["f0_bin"], out["snr"]))
        cw_all = packed[:, :, :n_data].astype(np.int64)
        okf = packed[:, :, n_data] > 0.5
        meta = {"score": packed[:, :, n_data + 1],
                "t0_hop": packed[:, :, n_data + 2].astype(np.int64),
                "f0_bin": packed[:, :, n_data + 3].astype(np.int64),
                "snr": packed[:, :, n_data + 4]}

        results = []
        for wi in range(bsz):
            seen: dict[bytes, DecodeResult] = {}
            for k in range(top_k):
                if not okf[wi, k] or meta["score"][wi, k] < self.min_score:
                    continue
                cw = cw_all[wi, k]
                text = self.unpack(cw[: self.mp.code.k])
                if text is None:
                    continue
                key = bytes(cw[: self.mp.code.k].astype(np.uint8))
                dt = (meta["t0_hop"][wi, k] * spec.hop / WAVE_SR
                      - spec.signal_start_s)
                freq = meta["f0_bin"][wi, k] * spec.bin_hz
                r = DecodeResult(
                    message=text,
                    snr_db=round(float(meta["snr"][wi, k]), 1),
                    dt_s=round(float(dt), 2),
                    freq_hz=round(float(freq), 1),
                    score=float(meta["score"][wi, k]),
                    mode=self.mode,
                    payload_bits=cw[: self.mp.code.k].astype(np.uint8),
                )
                prev = seen.get(key)
                if prev is None or r.score > prev.score:
                    seen[key] = r
            results.append(sorted(seen.values(), key=lambda r: -r.score))
        return results

    def _chase(self, syms: np.ndarray, margin: np.ndarray, accept,
               seed: int) -> np.ndarray | None:
        """Stochastic erasure trials biased toward low-confidence symbols.

        Deep-erasure tiers: patterns keep only ~n-f most-confident symbols
        (down to k+2 kept), tolerating a couple of hard errors among the
        kept set.  A candidate only survives the soft re-encode acceptance
        in ``accept``, which the erased positions independently verify.
        """
        rng = np.random.default_rng(seed)
        n = len(syms)
        # erasure probability decreasing with confidence rank
        rank = np.empty(n, np.int64)
        rank[np.argsort(margin)] = np.arange(n)
        p = 0.9 - 0.8 * rank / (n - 1)
        f_deep = min(self.rs.n_parity - 2, n - 1)
        f_mid = min(self.rs.n_parity - 11, n - 1)
        best = None
        for t in range(self.chase_trials):
            f_target = f_mid if t < self.chase_trials // 3 else f_deep
            mask = rng.random(n) < p
            idx = np.nonzero(mask)[0]
            if len(idx) > f_target:
                # keep the lowest-confidence erasures
                idx = idx[np.argsort(margin[idx])[:f_target]]
            info = self.rs.decode(syms.copy(), erasures=list(map(int, idx)))
            s = accept(info)
            if s is not None and (best is None or s > best[1]):
                best = (info, s)
                if s > 0.8:
                    break
        return best[0] if best else None
