"""Sustained live-load soak: the full App at N channels in real time.

The reference's implicit capacity is ~60 decoder lines on one PC
(config.ini:45-145); BASELINE.md's north star is >=500 FT8-equivalent
channels per chip in real time.  The bench extrapolates that from batch
timings; THIS tool demonstrates it live: the complete application —
synthetic realtime SDR source -> ingest thread -> batched channelizer ->
UTC-framed windows -> DecoderPool -> spot handler — runs for M windows
at N channels, and the artifact records what the scheduler actually did:

  - stale drops (DecoderPool age shedding, reference DecoderPool.hpp:
    357-377) — MUST be zero at the claimed capacity;
  - ingest overruns (ring backpressure, Receiver.hpp:222-229 analogue);
  - decode busy fraction (the reference's dead statsLoop, alive here);
  - end-to-end latency: window close -> spot emission, per spot
    (deadline = one T/R period; a miss means decode fell behind cadence).

Usage:
    python tools/soak.py --channels 512 --windows 10   # -> SOAK.json

FT8 bursts are injected on a few channels every period so real spots
flow through the reporting path (handler wrapped, sockets not opened).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def build_config(tmp: Path, n_channels: int, fs: int, lo: int,
                 loglevel: int = 2):
    """INI with one synthetic realtime source and N FT8 decoder lines."""
    from cwsl_digi_tpu.config import load_config

    # channels spread across the usable band (stay 8 kHz inside the edges)
    freqs = np.linspace(lo - fs // 2 + 8000, lo + fs // 2 - 8000,
                        n_channels).astype(int)
    lines = "\n".join(f"decoder={f} FT8" for f in freqs)
    ini = tmp / "soak.ini"
    ini.write_text(f"""
[radio]
source=synthetic:?sr={fs}&lo={lo}&rt=1
[operator]
callsign=W2AXR
gridsquare=FN13
[decoders]
{lines}
[logging]
loglevel={loglevel}
logimmediately=true
""")
    return load_config(ini), freqs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=512)
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--bursts", type=int, default=6,
                    help="injected FT8 signals per 15 s period")
    ap.add_argument("--out", default="SOAK.json")
    ap.add_argument("--loglevel", type=int, default=2)
    args = ap.parse_args()

    from cwsl_digi_tpu import jaxcache

    jaxcache.enable()

    import tempfile

    from cwsl_digi_tpu.modes import ft8
    from cwsl_digi_tpu.modes.gfsk import gfsk_modulate_iq
    from cwsl_digi_tpu.runtime import app as app_mod
    from cwsl_digi_tpu.sdr.source import SyntheticSource

    fs, lo = 192_000, 14_096_000
    tmp = Path(tempfile.mkdtemp(prefix="soak_"))
    cfg, freqs = build_config(tmp, args.channels, fs, lo, args.loglevel)

    # capture the synthetic source as the app opens it, and pre-inject
    # FT8 bursts: per 15 s period, `bursts` channels get one signal at two
    # phases (windows are stream-aligned to a UTC boundary, so one of the
    # two phases lands decodable inside each frame)
    captured: dict = {}
    orig_open = app_mod.open_source

    def spy_open(spec, **kw):
        src = orig_open(spec, **kw)
        if isinstance(src, SyntheticSource):
            captured["src"] = src
            rng = np.random.default_rng(9)
            # UTC-anchored bursts: window framing is anchored at UTC 15 s
            # boundaries, so inject at boundary+dt (dt inside the decoder's
            # sync search) — sample-indexed injection would land at an
            # arbitrary phase of the capture window (the stream's sample
            # clock starts at an arbitrary wall offset)
            base = (int(time.time() // 15) + 1) * 15.0
            n_periods = args.windows + 4
            for p in range(n_periods):
                for b in range(args.bursts):
                    ch = int(rng.integers(0, args.channels))
                    f_off = float(freqs[ch] - lo) + float(
                        rng.uniform(800, 2200))
                    text = f"CQ W{p % 10}ABC FN{b % 10}{p % 10}"
                    burst = 0.12 * gfsk_modulate_iq(
                        ft8.encode_message(text), f_off,
                        ft8.SPS * fs // 12_000, fs, ft8.TONE_SPACING)
                    dt = 0.2 + float(rng.uniform(0.0, 1.0))
                    src.inject_at_utc(base + p * 15.0 + dt,
                                      burst.astype(np.complex64))
        return src

    app_mod.open_source = spy_open
    app = app_mod.App(cfg, max_runtime_s=(args.windows + 1.5) * 15.0)

    spots = []
    orig_handle = app.spots.handle

    def capture_spot(res, **kw):
        s = orig_handle(res, **kw)
        if s is not None:
            lat = time.time() - (kw.get("epoch_time", 0) + ft8.T_R)
            spots.append({"msg": res.message, "latency_s": round(lat, 3)})
        return s

    app.spots.handle = capture_spot

    print(f"soak: {args.channels} channels x {args.windows} windows "
          f"(realtime)", flush=True)
    t0 = time.monotonic()
    app.warmup()
    warmup_s = time.monotonic() - t0
    print(f"warmup {warmup_s:.0f} s; running...", flush=True)

    run_started = time.time()
    t = threading.Thread(target=app.run, daemon=True)
    t.start()
    t.join(timeout=(args.windows + 4) * 15.0 + 120.0)

    lats = np.asarray([s["latency_s"] for s in spots], np.float64)
    rx_overruns = sum(
        int(getattr(rx, "overruns", 0)) for rx in app.receivers.values())

    # per-stage breakdown (where the per-window budget goes).  channelize_wall is DISPATCH wall (the pipeline is
    # async end-to-end; device time shows up in decode_s, which blocks on
    # the result fetch).
    def _pct(xs, q):
        return round(float(np.percentile(np.asarray(xs, np.float64), q)), 2) \
            if len(xs) else None

    stages: dict = {}
    ch_wall = sum(rx.stage["channelize_wall_s"]
                  for rx in app.receivers.values())
    ch_audio = sum(rx.stage["channelized_audio_s"]
                   for rx in app.receivers.values())
    emit_lags = [v for rx in app.receivers.values()
                 for v in rx.stage["emit_lag"]]
    jobs = list(app.pool.stage_log)
    stages = {
        "channelize_dispatch_s_per_audio_s": round(
            ch_wall / max(ch_audio, 1e-9), 4),
        "window_close_lag_s": {"p50": _pct(emit_lags, 50),
                               "p95": _pct(emit_lags, 95),
                               "max": _pct(emit_lags, 100),
                               "series": [round(v, 2) for v in emit_lags]},
        "queue_wait_s": {"p50": _pct([j["queue_wait_s"] for j in jobs], 50),
                         "p95": _pct([j["queue_wait_s"] for j in jobs], 95)},
        "decode_s_per_batch": {
            "p50": _pct([j["decode_s"] for j in jobs], 50),
            "p95": _pct([j["decode_s"] for j in jobs], 95),
            "series": [j["decode_s"] for j in jobs]},
    }
    report = {
        "channels": args.channels,
        "windows": args.windows,
        "injected_per_window": args.bursts,
        "spots": len(spots),
        "unique_messages": len({s["msg"] for s in spots}),
        "stale_drops": app.pool.count_dropped_stale,
        "ingest_overruns": int(rx_overruns),
        "busy_fraction": round(app.pool.busy_fraction(), 3),
        "latency_s": {
            "p50": round(float(np.percentile(lats, 50)), 2) if len(lats)
            else None,
            "p95": round(float(np.percentile(lats, 95)), 2) if len(lats)
            else None,
            "max": round(float(lats.max()), 2) if len(lats) else None,
        },
        "deadline_misses": int((lats > ft8.T_R).sum()) if len(lats) else 0,
        "deadline_s": ft8.T_R,
        "stages": stages,
        "utc_anchor": [rx.utc_anchor for rx in app.receivers.values()],
        "run_started_utc": round(run_started, 2),
        "warmup_s": round(warmup_s, 1),
        "platform": None,
    }
    import jax

    report["platform"] = jax.devices()[0].platform
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
