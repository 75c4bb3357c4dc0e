"""Time-sharded channelizer: long capture windows split across devices with
FIR-halo exchange between neighbours.

The reference's "long sequence" dimension is capture-window length — up to
1800 s for FST4-1800 (21.6 M audio samples; buffer cap NTMAX at
source/DecoderPool.hpp:45-46).  Its answer is queue segregation; the
answer here is sequence parallelism: shard the window's time axis over the mesh,
exchange the ``FiltOrder - BlockSize`` mixed-sample halo between neighbors
(the overlap-save analogue of SSBD's workspace carry, source/SSBD.hpp:163-182),
and keep every device's FIR matmul local.

Implementation: ``shard_map`` over mesh axis ``t``; the halo moves with one
``jax.lax.ppermute`` (neighbor shift), which XLA lowers to a
point-to-point transfer (NVLink between the cards of one host).  Per-shard NCO phase offsets are host-precomputed
in float64 (no on-device trig, no drift).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from cwsl_digi_tpu.constants import SSB_BW
from cwsl_digi_tpu.dsp.channelizer import ChannelizerSpec, _cmul
from cwsl_digi_tpu.dsp.lowpass import build_ssb_filter


class TimeShardedChannelizer:
    """Channelize one long window with the time axis sharded over a mesh."""

    def __init__(
        self,
        fs: int,
        freqs_hz,
        mesh: Mesh,
        axis: str = "t",
        bw: int = SSB_BW,
        latency_log2: int = 3,
        is_usb: bool = True,
    ) -> None:
        freqs = np.asarray(freqs_hz, dtype=np.float64)
        self.spec = ChannelizerSpec(fs, len(freqs), bw, latency_log2, is_usb)
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.shape[axis]
        self._pd = -2.0 * np.pi * (freqs + self.spec.sign * bw / 2.0) / fs
        filt = build_ssb_filter(fs, bw, latency_log2)
        self.segs = filt.reshape(self.spec.num_ws, self.spec.block_size).T.astype(
            np.float32
        )

    def _tone_tables(self, t_local: int):
        """Host-f64 NCO tables: tone for one shard's local time range plus
        per-shard rotation offsets exp(j*pd*s*T_local)."""
        u = np.arange(t_local)
        ang = self._pd[:, None] * u[None, :]
        ang = np.angle(np.exp(1j * ang))
        tone = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
        s = np.arange(self.n_shards)
        ang_s = (self._pd[None, :] * t_local) * s[:, None]
        ang_s = np.angle(np.exp(1j * ang_s))
        shard_rot = np.stack(
            [np.cos(ang_s), np.sin(ang_s)], axis=-1
        ).astype(np.float32)                      # [n_shards, C, 2]
        return tone, shard_rot

    def channelize(self, iq: np.ndarray) -> jax.Array:
        """iq: complex [T] with T % (n_shards*BlockSize*n_shards) aligned;
        returns audio [C, T/BS] (sharded on the time axis)."""
        iq = np.asarray(iq)
        t = iq.shape[0]
        bs = self.spec.block_size
        n = self.n_shards
        if t % (n * bs) != 0:
            raise ValueError(f"window length must be a multiple of {n * bs}")
        t_local = t // n
        tone, shard_rot = self._tone_tables(t_local)
        iq_re = np.ascontiguousarray(iq.real, dtype=np.float32)
        iq_im = np.ascontiguousarray(iq.imag, dtype=np.float32)
        return _time_sharded_call(
            self.spec, self.mesh, self.axis,
            jnp.asarray(iq_re), jnp.asarray(iq_im),
            jnp.asarray(tone[0]), jnp.asarray(tone[1]),
            jnp.asarray(shard_rot), jnp.asarray(self.segs),
        )


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _time_sharded_call(
    spec: ChannelizerSpec,
    mesh: Mesh,
    axis: str,
    iq_re, iq_im,          # [T] replicated input split below
    tone_re, tone_im,      # [C, T_local] (same basis on every shard)
    shard_rot,             # [n_shards, C, 2] per-shard phase offset
    segs,                  # [BS, NumWS]
):
    bs, nws = spec.block_size, spec.num_ws
    h = spec.filt_order - bs
    n_shards = mesh.shape[axis]

    def local_fn(iq_re_l, iq_im_l, tone_re_l, tone_im_l, rot_l, segs_l):
        # iq_*_l: [T_local]; rot_l: [1, C, 2]
        c = tone_re_l.shape[0]
        t_loc = iq_re_l.shape[0]
        rr, ri = rot_l[0, :, 0][:, None], rot_l[0, :, 1][:, None]
        tr, ti = _cmul(tone_re_l, tone_im_l, rr, ri)
        mr, mi = _cmul(iq_re_l[None, :], iq_im_l[None, :], tr, ti)  # [C, T_loc]

        # halo: last h mixed samples from the left neighbor
        perm = [(i, i + 1) for i in range(n_shards - 1)]
        halo_r = jax.lax.ppermute(mr[:, t_loc - h:], axis, perm)
        halo_i = jax.lax.ppermute(mi[:, t_loc - h:], axis, perm)
        buf_r = jnp.concatenate([halo_r, mr], axis=1)
        buf_i = jnp.concatenate([halo_i, mi], axis=1)

        n_blocks = buf_r.shape[1] // bs
        n_out = t_loc // bs
        br = buf_r.reshape(c, n_blocks, bs)
        bi = buf_i.reshape(c, n_blocks, bs)
        bd_r = jnp.einsum("cbr,rs->cbs", br, segs_l,
                          preferred_element_type=jnp.float32)
        bd_i = jnp.einsum("cbr,rs->cbs", bi, segs_l,
                          preferred_element_type=jnp.float32)

        def diag(bd):
            cols = [jax.lax.slice_in_dim(bd[:, :, s], s, s + n_out, axis=1)
                    for s in range(nws)]
            return jnp.sum(jnp.stack(cols, axis=0), axis=0)

        y_r, y_i = diag(bd_r), diag(bd_i)

        # output selection with the *global* output index parity:
        # global t = shard_index * n_out + local t
        shard_idx = jax.lax.axis_index(axis)
        t_idx = (shard_idx * n_out + jnp.arange(n_out, dtype=jnp.int32)) % 4
        t_idx = t_idx[None, :]
        sign = jnp.float32(spec.sign)
        audio = jnp.select(
            [t_idx == 0, t_idx == 1, t_idx == 2],
            [y_r, -sign * y_i, -y_r],
            sign * y_i,
        )
        return audio

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P(axis), P()),
        out_specs=P(None, axis),
    )
    return fn(iq_re, iq_im, tone_re, tone_im, shard_rot, segs)
