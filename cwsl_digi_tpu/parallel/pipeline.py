"""The sharded skim step: wideband IQ -> channelize -> decode, over a mesh.

This is the production device program: one T/R capture window of wideband IQ
in, per-channel decode candidates out.  Channel-parallelism (the reference's
one-thread-per-Instance, SURVEY.md §2.3) becomes the mesh axis ``ch``:

- the channelizer's per-channel tables (NCO tone bases, FIR state) and the
  audio it produces are sharded on ``ch``;
- the FT8 decode program runs with the window batch = channel axis, also
  sharded on ``ch``;
- the wideband IQ block is replicated (every chip mixes the channels it
  owns from the same IQ) — the natural layout when channels >> chips, since
  IQ-per-window is small and XLA broadcasts it once to every device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cwsl_digi_tpu.constants import WAVE_SR
from cwsl_digi_tpu.dsp.channelizer import BatchChannelizer
from cwsl_digi_tpu.modes import ft8


class ShardedSkimStep:
    """Channel-sharded channelize+decode for one receiver's channel bank."""

    def __init__(
        self,
        fs: int,
        freqs_hz,
        mesh: Mesh,
        axis: str = "ch",
        decoder: ft8.FT8Decoder | None = None,
    ) -> None:
        self.mesh = mesh
        self.axis = axis
        freqs = list(np.atleast_1d(freqs_hz))
        self.n_channels = len(freqs)
        # shard_map shards the channel axis structurally: pad the channel
        # bank up to a multiple of the mesh (padded rows channelize 0 Hz
        # and their outputs are dropped in _fetch)
        n_dev = mesh.shape[axis]
        self._pad_channels = (-len(freqs)) % n_dev
        freqs = freqs + [0.0] * self._pad_channels
        self.chan = BatchChannelizer(fs, freqs)
        self.dec = decoder or ft8.FT8Decoder()
        self.n_total = len(freqs)

    def _sharding(self):
        return NamedSharding(self.mesh, P(self.axis))

    @property
    def _multihost(self) -> bool:
        return len(self.mesh.devices.flat) > len(
            [d for d in self.mesh.devices.flat
             if d.process_index == jax.process_index()])

    def _put(self, arr, sharding):
        """Place a host array under a (possibly process-spanning) sharding.

        Single-host: plain device_put.  Multi-host (jax.distributed over a
        global mesh): every process holds the same logical array and
        contributes its addressable shards via make_array_from_callback —
        the SPMD idiom for DCN-spanning meshes."""
        arr = np.asarray(arr)
        if not self._multihost:
            return jax.device_put(arr, sharding)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx])

    def _fetch(self, v) -> np.ndarray:
        """Global array -> this process's rows (all rows on single host).

        Channel-pad rows (always the global tail) are dropped."""
        if not self._multihost:
            return np.asarray(v)[: self.n_channels]
        shards = sorted(v.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        rows = np.concatenate([np.asarray(s.data) for s in shards])
        return rows[: len(self.local_channels)]

    @property
    def local_channels(self) -> list[int]:
        """Channel indices this process's decode outputs correspond to."""
        if not self._multihost:
            return list(range(self.n_channels))
        sh = self._sharding()
        out = []
        # key on (start, stop) tuples: slice is unhashable before 3.12
        spans = {(idx[0].start or 0,
                  self.n_total if idx[0].stop is None else idx[0].stop)
                 for idx in sh.addressable_devices_indices_map(
                     (self.n_total,)).values()}
        for start, stop in sorted(spans):
            # channel-pad rows live at the global tail; they are no one's
            out.extend(i for i in range(start, stop) if i < self.n_channels)
        return out

    def step(self, iq: np.ndarray) -> dict[str, np.ndarray]:
        """One capture window of wideband IQ -> decode outputs per channel.

        On a multi-process mesh, the returned arrays cover this process's
        ``local_channels`` (each host reports the channels it owns — the
        reference's per-host skimmer model over DCN)."""
        iq = np.asarray(iq)
        sh = self._sharding()
        rep = NamedSharding(self.mesh, P())

        chan = self.chan
        t = iq.shape[0]
        pad = (-t) % chan._sub
        iq_re = np.pad(iq.real.astype(np.float32), (0, pad))
        iq_im = np.pad(iq.imag.astype(np.float32), (0, pad))
        rot_re, rot_im, step_re, step_im = chan._rot_powers(len(iq_re) // chan._sub)
        n_audio = t // chan.spec.block_size

        dec = self.dec
        sh2 = NamedSharding(self.mesh, P(None, self.axis))
        state_sh = {"hist_re": sh, "hist_im": sh,
                    "phasor_re": sh, "phasor_im": sh, "out_phase": rep}
        out = _skim_program(
            chan.spec, dec.spec, (n_audio,), self.mesh, self.axis, dec.bp,
            self._put(iq_re, rep),
            self._put(iq_im, rep),
            self._put(np.asarray(chan.tone_re), sh),
            self._put(np.asarray(chan.tone_im), sh),
            self._put(np.asarray(rot_re), sh2), self._put(np.asarray(rot_im), sh2),
            self._put(np.asarray(step_re), sh), self._put(np.asarray(step_im), sh),
            self._put(np.asarray(chan.segs), rep),
            {k: self._put(np.asarray(v), state_sh[k])
             for k, v in chan.init_state().items()},
            self._put(dec._crc_mat, rep), self._put(dec._bitmaps, rep),
            self._put(dec._window, rep), self._put(dec._data_syms, rep),
        )
        return {k: self._fetch(v) for k, v in out.items()}

    def decode_window(self, iq: np.ndarray) -> list[list[ft8.DecodeResult]]:
        """Full host-level result: channelize + decode + unpack messages.

        Returns one DecodeResult list per configured channel.
        """
        out = self.step(iq)
        return ft8.results_from_arrays(out)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _skim_program(
    chan_spec, dec_spec, shapes, mesh, axis, bp,
    iq_re, iq_im,
    tone_re, tone_im, rot_re, rot_im, step_re, step_im, segs,
    chan_state,
    crc_mat, bitmaps, window, data_syms,
):
    """Channelize + decode, shard_map'd over the channel axis.

    The program is embarrassingly parallel over channels, but expressing
    that through GSPMD propagation alone does not survive the decode
    program's reshapes: measured on an 8-device CPU mesh, the partitioner
    left the decode stages replicated (per-device FLOPs dropped only
    1.4x, 39 all-gathers).  shard_map makes the partition structural —
    each device runs the entire local program on its own channel rows,
    zero collectives."""
    from cwsl_digi_tpu.dsp.channelizer import _channelize_block
    from cwsl_digi_tpu.modes.gfsk_engine import decode_program

    (n_audio,) = shapes
    rep = P()
    ch2 = P(axis)               # [C, ...] per-channel tables / outputs
    state_specs = {"hist_re": ch2, "hist_im": ch2,
                   "phasor_re": P(axis), "phasor_im": P(axis),
                   "out_phase": rep}

    def local(iq_re, iq_im, tone_re, tone_im, rot_re, rot_im,
              step_re, step_im, segs, chan_state,
              crc_mat, bitmaps, window, data_syms):
        audio, _ = _channelize_block(
            chan_spec, iq_re, iq_im, tone_re, tone_im,
            rot_re, rot_im, step_re, step_im, segs, chan_state,
        )
        return decode_program(dec_spec, (n_audio,), audio[:, :n_audio],
                              crc_mat, bitmaps, window, bp, data_syms)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(rep, rep, ch2, ch2, P(None, axis), P(None, axis),
                  P(axis), P(axis), rep, state_specs,
                  rep, rep, rep, rep),
        out_specs=ch2,
        check_vma=False,
    )(iq_re, iq_im, tone_re, tone_im, rot_re, rot_im,
      step_re, step_im, segs, chan_state,
      crc_mat, bitmaps, window, data_syms)
