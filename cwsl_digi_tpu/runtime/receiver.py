"""Receiver: one IQ source -> ingest ring -> batched channelizer -> jobs.

Replaces the reference's Receiver thread + one Instance thread per channel
(source/Receiver.hpp:52-302, source/Instance.cpp:30-344): an ingest thread
fills a ~3 s block ring (the reference's SPMC IQ ring, Receiver.hpp:132)
and a channelize thread drains it through the BatchChannelizer (all
channels at once), framing per-mode capture windows by *stream time*
(sample counting) and pushing one batched DecodeJob per (mode, window) to
the pool.  Splitting ingest from the device call means a slow channelize
dispatch can never lap the source's own ring (round-2 finding); when the
source is the native shm reader, the intake runs as a fully native
shm->ring pump (native/cwsl_native.cpp, ≙ Receiver::readIQ).

Window framing notes:
- the reference stamps windows with wall-clock UTC and swaps per-channel
  double buffers on cadence ticks (Instance.cpp:203-251); with stream-time
  framing the k-th window covers audio samples [k*T_R*12000, (k+1)*...),
  and the UTC stamp is ``utc_anchor + k*T_R`` — identical for live sources
  (anchored at a UTC boundary) and deterministic for replay;
- live sources are additionally RE-anchored at every window boundary: the
  ingest thread stamps (samples, wall) pairs, and when the stream clock
  drifts from UTC (SDR sample-clock ppm error) the next window slips or
  clips a few samples so window starts track true UTC like the reference's
  per-window wall-clock swap (Instance.cpp:203-221) — 10 ppm would
  otherwise clip FT8 bursts after a day;
- the channelizer state is NOT reset between windows (phase-continuous
  streaming); the reference resets SSBD phase per window (Instance.cpp:251)
  only because its decoders are external — decode results are phase
  invariant.
"""

from __future__ import annotations

import collections
import enum
import functools
import threading
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from cwsl_digi_tpu.config import DecoderLine
from cwsl_digi_tpu.constants import WAVE_SR, Mode, get_rx_period
from cwsl_digi_tpu.dsp.channelizer import BatchChannelizer
from cwsl_digi_tpu.runtime.decoderpool import DecodeJob, DecoderPool
from cwsl_digi_tpu.sdr.source import IQSource


class Status(enum.Enum):
    """Reference: source/Receiver.hpp:45-50."""

    NOT_INITIALIZED = "Uninitialized"
    RUNNING = "Running"
    STOPPED = "Stopped"
    FINISHED = "Finished"


_EOF = object()   # end-of-stream sentinel between ingest and channelize


# --- device-side window framing programs -----------------------------------
# Audio stays on device from channelizer to decoder: no channelized chunk
# is fetched to the host and no framed window is re-uploaded.  Framing is
# three tiny fixed-shape programs over a per-mode
# device buffer [C_m, N_m + 2*G] (G = audio samples per channelize chunk),
# with all bookkeeping (write cursor, skip, carry) host-side integers
# passed as traced scalars so nothing recompiles.

@jax.jit
def _framer_write(buf, chunk, rows, w, off):
    """Write chunk[rows, off:] at buf[:, w:]; the zero tail past the valid
    samples is overwritten by the next chunk."""
    sel = jnp.take(chunk, rows, axis=0)
    padded = jnp.concatenate([sel, jnp.zeros_like(sel)], axis=1)
    shifted = jax.lax.dynamic_slice(padded, (0, off), sel.shape)
    return jax.lax.dynamic_update_slice(buf, shifted, (0, w))


@functools.partial(jax.jit, static_argnums=(2,))
def _framer_rotate(buf, start, g2):
    """Move buf[:, start:start+g2] to the front (leftover + carry)."""
    head = jax.lax.dynamic_slice(buf, (0, start), (buf.shape[0], g2))
    return jax.lax.dynamic_update_slice(buf, head, (0, 0))


@jax.jit
def _framer_zero_tail(buf, w):
    """Zero everything at/after the write cursor (end-of-stream flush)."""
    mask = jnp.arange(buf.shape[1]) < w
    return jnp.where(mask[None, :], buf, 0.0)


class _IngestRing:
    """Bounded block ring between the ingest and channelize threads.

    Python counterpart of the native SPMC ring (native/cwsl_native.cpp):
    ~3 s deep like the reference (Receiver.hpp:132, ((SR/iq_len)+1)*3
    blocks).  ``push`` applies backpressure (blocks when full, the
    reference's wait_for_empty_slot, Receiver.hpp:222-229) so bursts are
    absorbed by the *source's* ring, where overruns are counted rather
    than silent.  Each push is stamped with the ingest-side wall clock so
    the re-anchoring estimator sees arrival time, not dequeue time.
    """

    def __init__(self, n_blocks: int) -> None:
        self.n_blocks = max(2, n_blocks)
        self._dq: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._samples = 0           # IQ samples ever pushed
        self._wall = None           # wall stamp of the newest push

    def push(self, block, wall: float, timeout: float = 1.0) -> bool:
        with self._cv:
            if len(self._dq) >= self.n_blocks:
                self._cv.wait_for(lambda: len(self._dq) < self.n_blocks,
                                  timeout)
                if len(self._dq) >= self.n_blocks:
                    return False
            self._dq.append(block)
            if block is not _EOF:
                self._samples += len(block)
                self._wall = wall
            self._cv.notify_all()
            return True

    def pop(self, timeout: float = 1.0):
        with self._cv:
            if not self._dq:
                self._cv.wait_for(lambda: bool(self._dq), timeout)
                if not self._dq:
                    return None
            item = self._dq.popleft()
            self._cv.notify_all()
            return item

    def stamp(self) -> tuple[int, float] | None:
        """(IQ samples ingested, wall clock at the newest arrival)."""
        with self._cv:
            if self._wall is None:
                return None
            return self._samples, self._wall


class Receiver:
    """One capture source and every decoder line tuned within it."""

    def __init__(
        self,
        source: IQSource,
        lines: list[DecoderLine],
        pool: DecoderPool,
        utc_anchor: float = 0.0,
        log: Callable[[str], None] | None = None,
        decoder_index_base: int = 0,
        line_indices: list[int] | None = None,
        align_live: bool = False,
        wall_fn: Callable[[], float] | None = None,
        ring_seconds: float = 3.0,
    ) -> None:
        self.source = source
        self.lines = list(lines)
        self.pool = pool
        self.log = log or (lambda s: None)
        self.utc_anchor = utc_anchor
        # live sources: discard IQ until wall clock reaches the anchor so
        # stream-time window k really starts at utc_anchor + k*T_R (the
        # reference's cadence threads achieve the same via wall-clock swaps,
        # source/CWSL_DIGI.cpp:174-451)
        self.align_live = align_live
        self._drop_remaining = 0
        self._dropped_iq = 0        # IQ discarded by the align-to-anchor drop
        self.status = Status.NOT_INITIALIZED
        self._terminate = threading.Event()
        self._thread: threading.Thread | None = None
        self._ingest_thread: threading.Thread | None = None
        self._wall = wall_fn or time.time
        # ingest ring depth ≙ reference's ~3 s SPMC ring (Receiver.hpp:132)
        blk = max(1, getattr(source, "block_size", 0) or
                  source.sample_rate // 4)
        self._ring = _IngestRing(int(ring_seconds * source.sample_rate
                                     / blk) + 1)
        self._pump = None           # native shm->ring pump when applicable
        self.line_indices = line_indices or [
            decoder_index_base + i for i in range(len(lines))
        ]

        fs = source.sample_rate
        lo = source.lo_freq
        freqs = [line.calibrated_freq - lo for line in lines]
        for line, f in zip(lines, freqs):
            if abs(f) > fs / 2:
                raise ValueError(
                    f"decoder {line.freq} {line.mode.value} outside source band"
                )
        self.chan = BatchChannelizer(fs, freqs)
        self._sub_gran = self.chan._sub

        # group channel rows by mode for window framing
        self._mode_rows: dict[Mode, list[int]] = {}
        for i, line in enumerate(lines):
            self._mode_rows.setdefault(line.mode, []).append(i)
        # fixed channelize chunk: IQ in multiples of the tone sub-block so
        # the channelizer and the framing programs each compile exactly once
        self._g_iq = max(self._sub_gran,
                         int(round(self.CHANNELIZE_CHUNK_S * fs
                                   / self._sub_gran)) * self._sub_gran)
        self._g_a = self._g_iq // self.chan.spec.decimation
        # per-mode DEVICE assembly buffers [C_mode, window + 2*chunk slack].
        # Each mode's windows must start on ITS OWN period boundary (the
        # reference's per-cadence sync threads, CWSL_DIGI.cpp:174-451):
        # audio before the first boundary of T_m at/after utc_anchor is
        # skipped per mode.
        self._dev_buf: dict[Mode, jax.Array] = {}
        self._rows_dev: dict[Mode, jax.Array] = {}
        self._win_len: dict[Mode, int] = {}
        self._written: dict[Mode, int] = {}
        self._window_index: dict[Mode, int] = {}
        self._skip: dict[Mode, int] = {}
        self._epoch0: dict[Mode, float] = {}
        for mode, rows in self._mode_rows.items():
            trp = get_rx_period(mode)
            n = int(round(trp * WAVE_SR))
            self._win_len[mode] = n
            self._dev_buf[mode] = jnp.zeros(
                (len(rows), n + 2 * self._g_a), jnp.float32)
            self._rows_dev[mode] = jnp.asarray(rows, jnp.int32)
            self._written[mode] = 0
            self._window_index[mode] = 0
            k = int(np.ceil((utc_anchor - 1e-6) / trp))
            boundary = max(k, 0) * trp
            self._epoch0[mode] = boundary
            self._skip[mode] = int(round((boundary - utc_anchor) * WAVE_SR))
        self._stage_iq: list[np.ndarray] = []   # blocks awaiting a chunk
        self._stage_n = 0
        self._dec_ratio = source.sample_rate / WAVE_SR
        self._audio_pos = 0     # audio samples fed to framing so far
        # stage timing for the soak artifact: where the real-time budget
        # goes (channelize device wall, window-close lag vs nominal UTC)
        self.stage = {
            "channelize_wall_s": 0.0,     # total wall in chan.process
            "channelized_audio_s": 0.0,   # audio seconds produced
            "emit_lag": collections.deque(maxlen=4096),  # close lag [s]
        }

    # -- reference API ------------------------------------------------------

    def warm(self) -> None:
        """Compile the channelize + framing programs before the stream
        starts.  A first-chunk compile would stall the framing thread and
        push the first windows
        past their deadline; run a throwaway zero chunk through every
        program instead, with the channelizer state restored after."""
        saved = self.chan.state
        try:
            audio = self.chan.process(np.zeros(self._g_iq, np.complex64))
            for mode in self._mode_rows:
                buf = _framer_write(self._dev_buf[mode], audio,
                                    self._rows_dev[mode], jnp.int32(0),
                                    jnp.int32(0))
                buf = _framer_rotate(buf, jnp.int32(self._win_len[mode]),
                                     2 * self._g_a)
                _framer_zero_tail(buf, jnp.int32(0))
            np.asarray(audio[0, :1])          # block until compiled
        finally:
            self.chan.state = saved

    def set_anchor(self, utc_anchor: float) -> None:
        """Re-anchor window framing at a new UTC boundary (called after
        :meth:`warm`, whose compile time would otherwise have consumed
        the anchor chosen at construction)."""
        self.utc_anchor = utc_anchor
        for mode in self._mode_rows:
            trp = get_rx_period(mode)
            k = int(np.ceil((utc_anchor - 1e-6) / trp))
            boundary = max(k, 0) * trp
            self._epoch0[mode] = boundary
            self._skip[mode] = int(round((boundary - utc_anchor) * WAVE_SR))
            self._window_index[mode] = 0

    def init(self) -> None:
        self.status = Status.RUNNING
        # native shm source: the intake thread is the C++ pump
        # (native/cwsl_native.cpp, ≙ Receiver::readIQ at ABOVE_NORMAL)
        try:
            from cwsl_digi_tpu.native import (NativePump, NativeRing,
                                              NativeShmSource)

            if isinstance(self.source, NativeShmSource):
                nring = NativeRing(self.source.block_size * 8,
                                   self._ring.n_blocks)
                self._native_reader = nring.add_reader()
                self._pump = NativePump(self.source, nring)
                self._native_ring = nring
        except Exception:
            self._pump = None
        if self._pump is None:
            self._ingest_thread = threading.Thread(
                target=self._ingest_loop, name="receiver-ingest", daemon=True)
            self._ingest_thread.start()
        self._thread = threading.Thread(target=self._run,
                                        name="receiver-channelize",
                                        daemon=True)
        self._thread.start()

    def terminate(self) -> None:
        self._terminate.set()
        if self._pump is not None:
            self._pump.stop()
            self._pump = None
        if self._ingest_thread is not None:
            self._ingest_thread.join(timeout=3.0)
            self._ingest_thread = None
        if self._thread is not None:
            self._thread.join(timeout=3.0)
            self._thread = None
        if self.status == Status.RUNNING:
            self.status = Status.STOPPED

    def get_status(self) -> Status:
        return self.status

    @property
    def overruns(self) -> int:
        """Source blocks lost to ring overrun (0 in healthy operation)."""
        n = int(getattr(self.source, "overruns", 0))
        if self._pump is not None:
            n += self._pump.dropped
        return n

    # -- processing ---------------------------------------------------------

    def _ingest_loop(self) -> None:
        """Source -> ring at elevated priority (≙ readIQ, Receiver.hpp:209).

        Nothing here may block on the device: a slow channelize dispatch
        backs up the ring, the ring backpressures this thread, and losses
        happen (counted!) in the source's own ring instead of silently.
        """
        from cwsl_digi_tpu.utils import qos

        qos.set_current_thread_nice(qos.INGEST)
        try:
            while not self._terminate.is_set():
                block = self.source.read_block(timeout=1.0)
                if block is None:
                    # live sources time out when the writer is idle — keep
                    # waiting; only a true end-of-stream ends intake
                    # (reference: SM.WaitForNewData timeout just loops,
                    # Receiver.hpp:235-237)
                    if getattr(self.source, "live", False):
                        continue
                    break
                wall = self._wall()
                while not self._terminate.is_set():
                    if self._ring.push(block, wall, timeout=0.5):
                        break
        except Exception as e:
            self.log(f"### receiver ingest error: {e!r}")
        while not self._terminate.is_set():
            if self._ring.push(_EOF, 0.0, timeout=0.5):
                break

    def _next_block(self):
        """Dequeue the next IQ block (native pump ring or Python ring)."""
        if self._pump is not None:
            blk = self._native_ring.pop(self._native_reader, timeout=1.0)
            if blk is None and not getattr(self.source, "live", False):
                return _EOF
            return blk
        return self._ring.pop(timeout=1.0)

    def _ingest_stamp(self) -> tuple[int, float] | None:
        """(IQ samples ingested, wall at newest arrival) for re-anchoring."""
        if self._pump is not None:
            n = self._native_ring.write_count * self.source.block_size
            return (n, self._wall()) if n else None
        return self._ring.stamp()

    # Fixed channelize chunk length in seconds (rounded to the tone
    # sub-block).  One fixed size keeps every device program compiled
    # exactly once; window-close latency is bounded by this value since
    # staged IQ shorter than a chunk waits for the next block.  Round 4
    # used 2 s to amortize a host fetch per chunk; device-side framing
    # removed that fetch, so the chunk can ride the source block cadence
    # (~0.25 s, the CWSL block rate) — dispatches are async and cheap.
    CHANNELIZE_CHUNK_S = 0.25

    def _next_block_nowait(self):
        if self._pump is not None:
            return self._native_ring.pop(self._native_reader, timeout=0.0)
        return self._ring.pop(timeout=0.0)

    def _run(self) -> None:
        if self.align_live:
            delay = self.utc_anchor - self._wall()
            if delay > 0:
                self._drop_remaining = int(delay * self.source.sample_rate)
        try:
            eof = False
            while not self._terminate.is_set() and not eof:
                block = self._next_block()
                if block is None:
                    continue
                if block is _EOF:
                    eof = True
                    continue
                if self._drop_remaining > 0:
                    n = min(self._drop_remaining, len(block))
                    self._drop_remaining -= n
                    self._dropped_iq += n
                    block = block[n:]
                if len(block):
                    self.process_iq(block)
            if eof:
                self.status = Status.FINISHED
                self._flush_stream()
                self._flush_partials()
        except Exception as e:
            self.log(f"### receiver error: {e!r}")
            self.status = Status.STOPPED

    def process_iq(self, block: np.ndarray) -> None:
        """Feed one IQ block (any length); channelize in fixed chunks.

        Blocks are staged until a full ``self._g_iq`` chunk is available —
        a fixed chunk length means the channelizer and the device framing
        programs each compile once, and a backlog after a stall drains in
        big batches (the round-4 greedy drain, now implicit)."""
        self._stage_iq.append(np.asarray(block, np.complex64))
        self._stage_n += len(block)
        while self._stage_n >= self._g_iq:
            iq = (np.concatenate(self._stage_iq) if len(self._stage_iq) > 1
                  else self._stage_iq[0])
            rest = iq[self._g_iq:]
            self._stage_iq = [rest] if len(rest) else []
            self._stage_n = len(rest)
            self._process_chunk(iq[: self._g_iq])

    def _flush_stream(self) -> None:
        """End-of-stream: pad the staged remainder to one chunk."""
        if self._stage_n == 0:
            return
        iq = np.concatenate(self._stage_iq) if len(self._stage_iq) > 1 \
            else self._stage_iq[0]
        self._stage_iq = []
        n_valid_audio = self._stage_n // self.chan.spec.decimation
        self._stage_n = 0
        pad = self._g_iq - len(iq)
        if pad > 0:
            iq = np.concatenate([iq, np.zeros(pad, np.complex64)])
        self._process_chunk(iq, valid_audio=n_valid_audio)

    def _process_chunk(self, iq_fixed: np.ndarray,
                       valid_audio: int | None = None) -> None:
        t0 = time.monotonic()
        audio = self.chan.process(iq_fixed)       # [C, G_a], device-resident
        self.stage["channelize_wall_s"] += time.monotonic() - t0
        self.stage["channelized_audio_s"] += audio.shape[1] / WAVE_SR
        self._accumulate(audio, valid=valid_audio)

    def _accumulate(self, audio, valid: int | None = None) -> None:
        """Frame one channelized chunk into the per-mode device buffers.

        ``audio`` is normally the device-resident [C, G_a] chunk straight
        from the channelizer; tests may pass arbitrary-length host arrays,
        which are zero-padded to G_a sub-chunks (the zero tail is never
        counted as written, so the next write overwrites it)."""
        if not isinstance(audio, jax.Array) or audio.shape[1] != self._g_a:
            a = np.asarray(audio, np.float32)
            for pos in range(0, a.shape[1], self._g_a):
                piece = a[:, pos : pos + self._g_a]
                v = piece.shape[1]
                if v < self._g_a:
                    piece = np.pad(piece, ((0, 0), (0, self._g_a - v)))
                self._accumulate(jnp.asarray(piece), valid=v)
            return
        v = self._g_a if valid is None else valid
        if v == 0:
            return
        chunk_start = self._audio_pos
        self._audio_pos += v
        for mode in self._mode_rows:
            if self._skip[mode] >= v:
                self._skip[mode] -= v
                continue
            off = self._skip[mode]
            self._skip[mode] = 0
            w = self._written[mode]
            self._dev_buf[mode] = _framer_write(
                self._dev_buf[mode], audio, self._rows_dev[mode],
                jnp.int32(w), jnp.int32(off))
            w += v - off
            n_m = self._win_len[mode]
            while w >= n_m:
                leftover = w - n_m
                end_abs = chunk_start + v - leftover
                carry = self._emit(
                    mode, self._dev_buf[mode][:, :n_m], end_abs)
                self._dev_buf[mode] = _framer_rotate(
                    self._dev_buf[mode], jnp.int32(n_m - carry),
                    2 * self._g_a)
                w = leftover + carry
            self._written[mode] = w

    # re-anchoring: correct only past this misalignment, and never move a
    # boundary by more than trp/8 at once (jitter guard)
    REANCHOR_THRESH_S = 0.02

    def _reanchor_samples(self, mode: Mode, end_pos: int) -> int:
        """Window-boundary correction, in audio samples (+carry / -skip).

        The reference swaps buffers on wall-clock ticks every window
        (Instance.cpp:203-221), so window starts always track UTC.  Here
        the equivalent: the ingest thread's (samples, wall) stamps give
        the arrival wall time of the just-finished window's last sample;
        if it differs from the window's nominal UTC end, the next window
        reuses a tail (stream slow) or skips ahead (stream fast).
        """
        if not getattr(self.source, "live", False):
            return 0
        stamp = self._ingest_stamp()
        if stamp is None:
            return 0
        iq_in, wall = stamp
        # the ingest stamp counts RAW pushed IQ; the align-to-anchor drop
        # discarded the pre-anchor samples, which exist in the stamp but
        # not in the framed stream.  Without the correction the estimator
        # places wall_at_end up to one period in the past, decides the
        # stream is "early" every window, and skips trp/8 per window until
        # the framing is misaligned by the whole drop (measured: close lag
        # growing 0.3 -> 10.8 s over 6 windows in a 64-channel soak, with
        # every UTC-aligned burst landing undecodable after window 2)
        iq_in -= self._dropped_iq
        audio_in = iq_in / self._dec_ratio
        if audio_in < end_pos:      # stamp older than this boundary: skip
            return 0
        wall_at_end = wall - (audio_in - end_pos) / WAVE_SR
        trp = get_rx_period(mode)
        # _window_index was already advanced to k+1; the finished window's
        # nominal end is epoch0 + (k+1)*trp
        nominal_end = self._epoch0[mode] + self._window_index[mode] * trp
        mis = wall_at_end - nominal_end
        if abs(mis) < self.REANCHOR_THRESH_S:
            return 0
        max_corr = int(trp * WAVE_SR) // 8
        n = int(round(mis * WAVE_SR))
        n = max(-max_corr, min(max_corr, n))
        self.log(f"re-anchor {mode.value}: stream {'late' if n > 0 else 'early'}"
                 f" {abs(mis):.3f}s, {'carrying' if n > 0 else 'skipping'}"
                 f" {abs(n)} samples")
        return n

    def _emit(self, mode: Mode, window, end_pos: int | None = None) -> int:
        """Push one framed DEVICE window to the pool; returns the carry
        (samples of the window tail the next window reuses, when the
        stream runs slow vs UTC).  A fast stream adds to the skip counter
        instead (consumed from subsequent chunks)."""
        rows = self._mode_rows[mode]
        k = self._window_index[mode]
        trp = get_rx_period(mode)
        job = DecodeJob(
            mode=mode,
            audio=window,
            base_freqs=[self.lines[i].freq for i in rows],
            decoder_indices=[self.line_indices[i] for i in rows],
            # exact window-start epoch; FT4 windows start on half
            # seconds, so no int truncation here (wire formats that
            # need integer seconds truncate at the presentation layer)
            epoch_time=self._epoch0[mode] + k * trp,
            wspr_callsigns=[self.lines[i].wspr_call for i in rows],
        )
        self.pool.push(job)
        if getattr(self.source, "live", False):
            # window-close lag: how long after the window's nominal UTC
            # end the framed audio actually left for the pool (framing
            # slip = ingest + channelize falling behind the cadence)
            self.stage["emit_lag"].append(
                round(self._wall() - (job.epoch_time + trp), 3))
        self._window_index[mode] = k + 1
        if end_pos is None:
            return 0
        n = self._reanchor_samples(mode, end_pos)
        if n < 0:                   # stream fast: drop samples to realign
            self._skip[mode] += -n
            return 0
        # stream slow: next window reuses the tail (bounded by the rotate
        # program's fixed slack — a correction this size never happens in
        # one step, REANCHOR clamps at trp/8 and real drift is ms-scale)
        return min(n, self._g_a)

    def _flush_partials(self) -> None:
        """On end-of-stream, emit any window at least half filled (replay
        convenience; the reference simply loses the partial window)."""
        for mode in self._mode_rows:
            n_m = self._win_len[mode]
            if self._written[mode] >= n_m // 2:
                buf = _framer_zero_tail(self._dev_buf[mode],
                                        jnp.int32(self._written[mode]))
                self._written[mode] = 0
                self._emit(mode, buf[:, :n_m])
