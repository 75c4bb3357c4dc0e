"""Batched channelizer: NCO mix + polyphase FIR decimation, all channels at once.

This is the device replacement for the reference's per-channel SSBD
threads (source/SSBD.hpp:42-221 driven by source/Instance.cpp:178-285): one
device program computes every configured channel of one receiver as rows of a
``[channels, time]`` batch.

Math (identical to the closed form in ``ssbd.py``): with ``BS = Fs/(2B)``,
``FO = latency*2*Fs/B`` and ``segs[r, s] = filter[s*BS + r]``::

    mixed[c, u]   = iq[u] * exp(-j*2*pi*(F_c + sign*B/2)/Fs * u)
    bd[c, b, s]   = sum_r mixed[c, b*BS + r] * segs[r, s]      (matmul)
    y[c, t]       = sum_s bd[c, t + s, s]                      (diagonal sum)
    audio[c, t]   = Re(y[c, t] * (j*sign)^t)

The ``bd`` matmul is the whole FIR: reshaping time into ``[blocks, BS]`` and
contracting BS against the NumWS filter segments maps the decimating FIR onto
a matrix product instead of a scalar tap loop.

Design decisions:

- **All complex arithmetic is split into real/imag pairs**, and complex
  dtypes never cross the jit boundary.  Nothing in the hardware requires
  this (the GPU takes complex64); it is how the code was first written.
- **No runtime trig.**  Channel frequencies are fixed at construction, so
  every NCO factor (the per-sample tone basis for one sub-block and the
  per-sub-block rotation powers) is precomputed in float64 NumPy and baked
  into the program as constants.  float32 phase-accumulation error therefore
  never grows with stream length; the only runtime complex ops are
  elementwise multiplies.
- **Streaming state is an explicit carry** (per-channel FIR history + NCO
  phasor + output-phase counter), the overlap-save analogue of the
  reference's workspace carry (SSBD.hpp:163-182); it supports halo-exchange
  time sharding (see parallel/).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from cwsl_digi_tpu.constants import SSB_BW
from cwsl_digi_tpu.dsp.lowpass import build_ssb_filter

# Sub-block length for the precomputed tone basis (samples). Must divide the
# caller's block length; process() pads internally if needed.
_TONE_SUB = 4096


@dataclasses.dataclass(frozen=True)
class ChannelizerSpec:
    """Static configuration for one receiver's channel bank."""

    fs: int                       # input IQ sample rate
    num_channels: int
    bw: int = SSB_BW
    latency_log2: int = 3
    is_usb: bool = True

    def __post_init__(self) -> None:
        if self.bw == 0 or (self.fs // self.bw // 2) * 2 * self.bw != self.fs \
                or self.fs < 4 * self.bw:
            raise ValueError("Fs/B must be an even integer >= 4")

    @property
    def block_size(self) -> int:
        return self.fs // self.bw // 2

    @property
    def filt_order(self) -> int:
        return (1 << self.latency_log2) * 2 * self.fs // self.bw

    @property
    def num_ws(self) -> int:
        return self.filt_order // self.block_size

    @property
    def out_rate(self) -> int:
        return 2 * self.bw  # 12 kHz for B=6 kHz

    @property
    def decimation(self) -> int:
        return self.block_size

    @property
    def sign(self) -> float:
        return 1.0 if self.is_usb else -1.0


def _cmul(ar, ai, br, bi):
    """Split-complex multiply: (ar+j·ai)·(br+j·bi)."""
    return ar * br - ai * bi, ar * bi + ai * br


@functools.partial(jax.jit, static_argnums=(0,))
def _channelize_block(
    spec: ChannelizerSpec,
    iq_re: jax.Array,          # [T] float32
    iq_im: jax.Array,          # [T] float32
    tone_re: jax.Array,        # [C, SUB] float32 — exp(j*pd*u), u in [0,SUB)
    tone_im: jax.Array,
    rot_re: jax.Array,         # [NSUB, C] float32 — exp(j*pd*SUB*b)
    rot_im: jax.Array,
    step_re: jax.Array,        # [C] float32 — exp(j*pd*T), whole-call advance
    step_im: jax.Array,
    segs: jax.Array,           # [BS, NumWS] float32 (filter segments)
    state: dict[str, jax.Array],
) -> tuple[jax.Array, dict[str, jax.Array]]:
    bs, nws = spec.block_size, spec.num_ws
    t_in = iq_re.shape[0]
    n_out = t_in // bs
    c = tone_re.shape[0]
    sub = tone_re.shape[1]

    # --- NCO tone: phasor * rot_powers[b] * tone_base[u_local] -----------
    ph_re = state["phasor_re"][:, None]
    ph_im = state["phasor_im"][:, None]
    pr, pi = _cmul(rot_re.T[:, :, None], rot_im.T[:, :, None],   # [C,NSUB,1]
                   ph_re[:, None, :], ph_im[:, None, :])
    tr, ti = _cmul(pr, pi, tone_re[:, None, :], tone_im[:, None, :])  # [C,NSUB,SUB]
    tr = tr.reshape(c, t_in)
    ti = ti.reshape(c, t_in)

    # --- mix -------------------------------------------------------------
    mr, mi = _cmul(iq_re[None, :], iq_im[None, :], tr, ti)        # [C, T]

    # advance the carried phasor by T samples (exp(j*pd*T), host-precomputed);
    # renormalize to unit magnitude to stop drift.
    nr, ni = _cmul(state["phasor_re"], state["phasor_im"], step_re, step_im)
    inv = jax.lax.rsqrt(nr * nr + ni * ni)
    phasor_re, phasor_im = nr * inv, ni * inv

    # --- polyphase FIR as a matmul ---------------------------------------
    buf_re = jnp.concatenate([state["hist_re"], mr], axis=1)      # [C, H+T]
    buf_im = jnp.concatenate([state["hist_im"], mi], axis=1)
    n_blocks = buf_re.shape[1] // bs
    br = buf_re.reshape(c, n_blocks, bs)
    bi = buf_im.reshape(c, n_blocks, bs)
    bd_r = jnp.einsum("cbr,rs->cbs", br, segs,
                      preferred_element_type=jnp.float32)
    bd_i = jnp.einsum("cbr,rs->cbs", bi, segs,
                      preferred_element_type=jnp.float32)

    # diagonal sum: y[c, t] = sum_s bd[c, t+s, s]
    def diag(bd):
        cols = [jax.lax.slice_in_dim(bd[:, :, s], s, s + n_out, axis=1)
                for s in range(nws)]
        return jnp.sum(jnp.stack(cols, axis=0), axis=0)

    y_r = diag(bd_r)
    y_i = diag(bd_i)

    # --- output selection: Re(y * (j*sign)^t) ----------------------------
    # cycles with period 4: +Re -> -sign*Im -> -Re -> +sign*Im
    # (reference: SSBD::Iterate, source/SSBD.hpp:132-135).
    t_idx = (state["out_phase"] + jnp.arange(n_out, dtype=jnp.int32)) % 4
    t_idx = t_idx[None, :]
    sign = jnp.float32(spec.sign)
    audio = jnp.select(
        [t_idx == 0, t_idx == 1, t_idx == 2],
        [y_r, -sign * y_i, -y_r],
        sign * y_i,
    )

    new_state = {
        "hist_re": buf_re[:, t_in:],
        "hist_im": buf_im[:, t_in:],
        "phasor_re": phasor_re,
        "phasor_im": phasor_im,
        "out_phase": (state["out_phase"] + n_out) % 4,
    }
    return audio, new_state


class BatchChannelizer:
    """All channels of one receiver, channelized in one device program.

    Replaces: one reference Instance thread per channel
    (source/Instance.cpp:178-285).
    """

    def __init__(
        self,
        fs: int,
        freqs_hz: np.ndarray | list[float],
        bw: int = SSB_BW,
        latency_log2: int = 3,
        is_usb: bool = True,
    ) -> None:
        freqs = np.asarray(freqs_hz, dtype=np.float64)
        self.spec = ChannelizerSpec(fs, len(freqs), bw, latency_log2, is_usb)
        for f in freqs:
            if abs(f) > fs / 2 or abs(f + self.spec.sign * bw) > fs / 2:
                raise ValueError(f"channel at {f} Hz outside band (Fs={fs})")
        self.freqs = freqs
        # NCO phase increment per channel (reference: SSBD::Tune,
        # source/SSBD.hpp:110-114).
        pd = -2.0 * np.pi * (freqs + self.spec.sign * bw / 2.0) / fs  # [C]
        self._pd = pd
        bs = self.spec.block_size
        self._sub = max(bs, (_TONE_SUB // bs) * bs)
        # Tone basis for one sub-block, computed in float64 then cast:
        # exp(j * pd * u), u in [0, SUB)
        u = np.arange(self._sub)
        ang = pd[:, None] * u[None, :]
        self.tone_re = jnp.asarray(np.cos(ang), jnp.float32)
        self.tone_im = jnp.asarray(np.sin(ang), jnp.float32)
        self._rot_cache: dict[int, tuple[jax.Array, jax.Array]] = {}

        filt = build_ssb_filter(fs, bw, latency_log2)
        # segs[r, s] = filter[s*BS + r]
        self.segs = jnp.asarray(
            filt.reshape(self.spec.num_ws, bs).T, dtype=jnp.float32
        )
        self.state = self.init_state()

    def _rot_powers(self, n_sub: int):
        """exp(j*pd*SUB*b) for b in [0, n_sub) plus the whole-call advance
        exp(j*pd*SUB*n_sub); float64 host trig, wrapped before casting."""
        if n_sub not in self._rot_cache:
            b = np.arange(n_sub + 1)
            ang = (self._pd * self._sub)[None, :] * b[:, None]    # [NSUB+1, C]
            ang = np.angle(np.exp(1j * ang))  # wrap to [-pi, pi) in f64
            self._rot_cache[n_sub] = (
                jnp.asarray(np.cos(ang[:-1]), jnp.float32),
                jnp.asarray(np.sin(ang[:-1]), jnp.float32),
                jnp.asarray(np.cos(ang[-1]), jnp.float32),
                jnp.asarray(np.sin(ang[-1]), jnp.float32),
            )
        return self._rot_cache[n_sub]

    def init_state(self) -> dict[str, jax.Array]:
        c = self.spec.num_channels
        h = self.spec.filt_order - self.spec.block_size
        return {
            "hist_re": jnp.zeros((c, h), jnp.float32),
            "hist_im": jnp.zeros((c, h), jnp.float32),
            "phasor_re": jnp.ones((c,), jnp.float32),
            "phasor_im": jnp.zeros((c,), jnp.float32),
            "out_phase": jnp.int32(0),
        }

    def reset(self) -> None:
        """Per-window phase reset (reference recreates SSBD each window,
        source/Instance.cpp:251)."""
        self.state = self.init_state()

    def _split(self, iq) -> tuple[jax.Array, jax.Array]:
        if isinstance(iq, (tuple, list)):
            re, im = iq
            return jnp.asarray(re, jnp.float32), jnp.asarray(im, jnp.float32)
        iq = np.asarray(iq)
        if np.iscomplexobj(iq):
            return (jnp.asarray(iq.real, jnp.float32),
                    jnp.asarray(iq.imag, jnp.float32))
        if iq.ndim == 2 and iq.shape[-1] == 2:
            return (jnp.asarray(iq[:, 0], jnp.float32),
                    jnp.asarray(iq[:, 1], jnp.float32))
        raise ValueError("iq must be complex, (re, im), or [T, 2]")

    def process(self, iq) -> jax.Array:
        """Stream one IQ block -> ``[channels, T//BS]`` audio at 12 kHz.

        ``iq`` may be a complex ndarray, an ``(re, im)`` pair, or ``[T, 2]``.
        Block length must be a multiple of the tone sub-block (``self._sub``);
        use :meth:`process_window` for arbitrary-length one-shot windows.
        """
        iq_re, iq_im = self._split(iq)
        t = iq_re.shape[0]
        if t % self._sub != 0:
            raise ValueError(f"block length must be a multiple of {self._sub}")
        rot_re, rot_im, step_re, step_im = self._rot_powers(t // self._sub)
        audio, self.state = _channelize_block(
            self.spec, iq_re, iq_im, self.tone_re, self.tone_im,
            rot_re, rot_im, step_re, step_im, self.segs, self.state
        )
        return audio

    def process_window(self, iq) -> jax.Array:
        """Channelize a whole capture window from phase-reset state.

        Pads the tail to a sub-block boundary and trims the output, so any
        window length that is a multiple of BlockSize works.
        """
        self.reset()
        iq_re, iq_im = self._split(iq)
        t = iq_re.shape[0]
        if t % self.spec.block_size != 0:
            raise ValueError(
                f"window length must be a multiple of {self.spec.block_size}"
            )
        n_out = t // self.spec.block_size
        pad = (-t) % self._sub
        if pad:
            iq_re = jnp.pad(iq_re, (0, pad))
            iq_im = jnp.pad(iq_im, (0, pad))
        audio = self.process((iq_re, iq_im))
        return audio[:, :n_out]
