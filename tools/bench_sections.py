"""Shared bench helpers + per-section entry points, one subprocess each.

bench.py runs the sections one after another, each in its own process, so
only one process holds the card at a time and the parent never opens it.
Every section refuses to run unless JAX's default backend is the GPU.

Each section entry prints ONE JSON line on stdout (other prints go to
stderr) and is invoked as:

    python tools/bench_sections.py <section> [args...]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def make_busy_windows(batch: int = 24, per_window: int = 6, seed: int = 5):
    """Realistic production mix: multiple signals per window + noise."""
    from parity import random_call, random_grid

    from cwsl_digi_tpu.modes import ft8

    rng = np.random.default_rng(seed)
    wlen = int(ft8.T_R * 12_000)
    noise_power = 0.5 / 2500.0 * (12_000 / 2.0)
    wins = np.empty((batch, wlen), np.float32)
    for w in range(batch):
        acc = rng.standard_normal(wlen) * np.sqrt(noise_power)
        slots = np.linspace(600, 2500, per_window) + rng.uniform(
            -40, 40, per_window)
        for f0 in slots:
            text = f"{random_call(rng)} {random_call(rng)} {random_grid(rng)}"
            snr = float(rng.uniform(-20, -5))
            acc += 10.0 ** (snr / 20.0) * ft8.synthesize(
                text, float(f0), start_s=float(rng.uniform(0.1, 1.0)))
        wins[w] = acc
    return wins


def section_device() -> dict:
    """Where the bench runs: JAX's device and the card's name and limit."""
    import subprocess

    import jax

    d = jax.devices()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return {"platform": d[0].platform, "device_kind": d[0].device_kind,
            "count": len(d), "nvidia_smi": smi.stdout.strip()}


def section_channelizer() -> dict:
    """Steady-state device s per channel-second of BatchChannelizer."""
    from cwsl_digi_tpu import jaxcache

    jaxcache.enable()
    import jax

    from cwsl_digi_tpu.dsp.channelizer import BatchChannelizer

    n_ch, fs = 256, 192_000
    rng = np.random.default_rng(0)
    bc = BatchChannelizer(fs, np.linspace(-fs / 2 + 8000, fs / 2 - 8000,
                                          n_ch))
    n = fs - fs % bc._sub
    iq_re = rng.standard_normal(n).astype(np.float32)
    iq_im = rng.standard_normal(n).astype(np.float32)
    jax.block_until_ready(bc.process((iq_re, iq_im)))    # compile
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(bc.process((iq_re, iq_im)))
    dt = (time.perf_counter() - t0) / reps
    return {"s_per_channel_second": dt / (n / fs) / n_ch}


def _upload_int16(audio: np.ndarray):
    """Host audio -> device f32, via the int16 peak-scaled wire format
    decode() itself uses for host inputs (Instance::prepareAudio analogue,
    reference source/Instance.cpp:294-338)."""
    import jax.numpy as jnp

    peak = np.abs(audio).max(axis=1, keepdims=True)
    scaled = (audio * (32000.0 / np.maximum(peak, 1e-30))).astype(np.int16)
    dev = jnp.asarray(scaled).astype(jnp.float32)
    np.asarray(dev[0, :1])                                # settle the wire
    return dev


def section_decode_production(batch: int = 0) -> dict:
    """Wall time per window of the full decode() path on a busy band.

    The windows are DEVICE-RESIDENT before the clock starts: in production
    the decoder's input comes from the on-device channelizer (runtime/
    receiver.py) and never transits the host — the per-channel share of
    the wideband IQ upload is counted in the channelizer section (a 192 kHz
    complex stream serves every channel of a band at once).  What IS timed:
    every decode dispatch, the depth-2 subtraction passes, OSD, all
    device->host result fetches, and the host-side unpack to messages.
    The host-fed path (int16 upload inside the clock) is reported
    separately as s_per_window_hostfed.
    """
    from cwsl_digi_tpu import jaxcache

    jaxcache.enable()
    from cwsl_digi_tpu.modes import ft8

    dec = ft8.FT8Decoder()
    batch = batch or dec.max_device_batch
    reps = 3
    batches = [make_busy_windows(batch, seed=5 + i)
               for i in range(reps + 1)]
    res = dec.decode(batches[0])                          # compile + warm
    n_decoded = sum(len(r) for r in res)
    devs = [_upload_int16(b) for b in batches[1:]]
    ts = []
    for d in devs:
        t0 = time.perf_counter()
        dec.decode(d)
        ts.append(time.perf_counter() - t0)
    # host-fed comparison point (upload inside the clock)
    t0 = time.perf_counter()
    dec.decode(batches[1])
    hostfed = time.perf_counter() - t0
    # median-of-3: one outlier must not set the headline
    return {"s_per_window": sorted(ts)[len(ts) // 2] / batch,
            "runs_s_per_window": [t / batch for t in ts],
            "s_per_window_hostfed": hostfed / batch,
            "decodes_per_window": n_decoded / batch, "batch": batch}


def section_recall(trials: int = 100) -> dict:
    import parity

    from cwsl_digi_tpu import jaxcache

    jaxcache.enable()
    snrs = [-18.0, -19.0, -20.0, -21.0, -22.0]
    r = parity.sweep_mode("FT8", trials, snrs=snrs, verbose=False)
    return {"recall": r["recall"], "trials": trials,
            "threshold_db": r["threshold_db"]}


def section_mode_decode(mode: str, batch: int = 0, reps: int = 2) -> dict:
    """Steady-state decode() wall seconds per window for one mode.

    Same discipline as the FT8 production section: device-resident
    windows (the channelizer feeds decode on device in production) and
    the decoder's FULL device chunk — the operating point of a loaded
    skimmer."""
    import parity

    from cwsl_digi_tpu import jaxcache

    jaxcache.enable()
    from cwsl_digi_tpu.modes.base import get_decoder
    from cwsl_digi_tpu.modes.gfsk import add_noise_at_snr

    rng = np.random.default_rng(11)
    cfg = parity.SWEEPS[mode]
    dec = get_decoder(mode)
    batch = batch or min(getattr(dec, "max_device_batch", 8), 24)
    batches = []
    for _ in range(reps + 1):
        wins = [add_noise_at_snr(
            parity.make_trial(mode, rng, cfg["f0"], cfg["dt"])[0],
            -10.0, 12_000, rng) for _ in range(batch)]
        batches.append(np.stack(wins))
    dec.decode(batches[0])                                # compile + warm
    from cwsl_digi_tpu.modes.gfsk_engine import GFSKDecoder

    # device-feed only decoders whose decode path is device-native; the
    # q-ary/WSPR hosts-side stages np.asarray their input, so a device
    # array would add a fetch instead of removing an upload
    if isinstance(dec, GFSKDecoder):
        batches = [_upload_int16(b) for b in batches[1:]]
    else:
        batches = batches[1:]
    ts = []
    for d in batches:
        t0 = time.perf_counter()
        dec.decode(d)
        ts.append(time.perf_counter() - t0)
    return {"s_per_window": min(ts) / batch, "batch": batch}


def section_qary_host_fraction(mode: str, batch: int = 8) -> dict:
    """Host-side share of a q-ary mode's decode wall time."""
    import parity

    from cwsl_digi_tpu import jaxcache

    jaxcache.enable()
    from cwsl_digi_tpu.modes.base import get_decoder
    from cwsl_digi_tpu.modes.gfsk import add_noise_at_snr

    rng = np.random.default_rng(13)
    cfg = parity.SWEEPS[mode]
    dec = get_decoder(mode)
    wins = np.stack([add_noise_at_snr(
        parity.make_trial(mode, rng, cfg["f0"], cfg["dt"])[0],
        -10.0, 12_000, rng) for _ in range(batch)])
    dec.decode(wins)                                      # compile + warm
    t0 = time.perf_counter()
    dec.decode_arrays(wins)
    dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec.decode(wins)
    tot = time.perf_counter() - t0
    return {"host_fraction": max(0.0, round(1.0 - dev / max(tot, 1e-9), 3))}


SECTIONS = {
    "device": section_device,
    "channelizer": section_channelizer,
    "decode_production": section_decode_production,
    "recall": section_recall,
    "mode_decode": section_mode_decode,
    "qary_host_fraction": section_qary_host_fraction,
}


def main() -> None:
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {jax.default_backend()!r}")
    name = sys.argv[1]
    args = []
    for a in sys.argv[2:]:
        try:
            args.append(int(a))
        except ValueError:
            args.append(a)
    out = SECTIONS[name](*args)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
