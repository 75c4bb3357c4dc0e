"""Headline benchmark: simultaneous real-time FT8 channels per card.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

The baseline is the north-star target of 500 simultaneous FT8-equivalent
channels in real time (BASELINE.md); the reference itself publishes no
numbers (its implicit capacity is ~60 channels on one PC,
config.ini:45-145).

Each timed section runs in its own subprocess (tools/bench_sections.py),
one after another, so only one process holds the card at a time; this
parent never opens it.  Any section that fails fails the run, and every
section refuses to run without a GPU.

What is measured:
  - device: JAX's platform, device kind and count, and the card's name and
    power limit from nvidia-smi;
  - channelizer: steady-state device time per channel-second at a real SDR
    rate (192 kHz, 256 channels);
  - decode: wall time of ``FT8Decoder.decode()`` — sync + depth subtraction
    passes + OSD + host unpack — on a realistic busy-band window mix
    (6 signals/window at −5..−20 dB), amortized over a full device chunk,
    with device-resident input (the channelizer feeds decode on device);
  - recall: FT8 recall at −18..−22 dB on randomized protocol-exact
    signals (the parity harness's sweep, tools/parity.py).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def _run_section(name: str, *args, timeout: int = 1800) -> dict:
    """Run one timed section in a fresh subprocess; parse its JSON line.
    Exits the bench when the section fails."""
    cmd = [sys.executable, os.path.join(REPO, "tools", "bench_sections.py"),
           name] + [str(a) for a in args]
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=timeout)
    for line in reversed(p.stdout.strip().splitlines()):
        line = line.strip()
        if p.returncode == 0 and line.startswith("{"):
            return json.loads(line)
    raise SystemExit(f"section {name} {' '.join(map(str, args))} failed "
                     f"(rc={p.returncode}): {p.stderr[-2000:]}")


# Reference channel-mix template: the shipped config.ini demonstrates 72
# decoder lines across 14 bands (reference config.ini:45-145); the mixed-
# mode capacity below uses exactly that distribution.
TEMPLATE_MIX = {
    "FT8": 18, "WSPR": 11, "FT4": 10, "JT65": 9, "JS8": 6,
    "FST4W-120": 3, "FST4-60": 3, "FST4-120": 3, "FST4W-300": 2,
    "FST4-300": 2, "Q65-30": 1, "FST4W-900": 1, "FST4W-1800": 1,
    "FST4-900": 1, "FST4-1800": 1,
}

# modes whose decode cost is measured directly in the bench; the long
# FST4 periods are modeled from FST4-120 by window-sample ratio
# (spectrogram-dominated cost, linear in samples) and labeled as such
MEASURED_MODES = ("FT4", "JS8", "WSPR", "JT65", "Q65-30",
                  "FST4-60", "FST4-120", "FST4W-120")


def _mixed_mode_channels(t_chan: float, s_per_window: dict) -> int:
    """Real-time channels/card for the reference's template mix.

    A mode-m channel consumes ``t_chan`` device-seconds per second of
    audio plus ``C_m / T_m`` decode-seconds per second; capacity is the
    N at which the weighted mix saturates one card-second per second.
    Modes not measured are the long FST4/FST4W periods, modeled from
    FST4-120 by window-sample ratio."""
    from cwsl_digi_tpu.constants import Mode, get_rx_period

    total_lines = sum(TEMPLATE_MIX.values())
    rate = 0.0
    for mode, n_lines in TEMPLATE_MIX.items():
        cost = s_per_window.get(mode)
        if cost is None:
            cost = (s_per_window["FST4-120"]
                    * get_rx_period(Mode(mode)) / 120.0)
        t_r = get_rx_period(Mode(mode))
        rate += (n_lines / total_lines) * (cost / t_r + t_chan)
    return int(1.0 / rate)


def main() -> None:
    from cwsl_digi_tpu.modes import ft8

    device = _run_section("device")
    print(f"# {device['nvidia_smi']}; {device['platform']} "
          f"{device['device_kind']} x{device['count']}", file=sys.stderr)
    t_chan = _run_section("channelizer")["s_per_channel_second"]
    prod = _run_section("decode_production")
    t_dec = prod["s_per_window"]
    curve = _run_section("recall")

    s_per_window = {"FT8": t_dec}
    for mode in MEASURED_MODES:
        r = _run_section("mode_decode", mode)
        s_per_window[mode] = round(r["s_per_window"], 5)
    mixed = _mixed_mode_channels(t_chan, s_per_window)
    host_frac = {mode: _run_section("qary_host_fraction", mode)[
        "host_fraction"] for mode in ("JT65", "Q65-30")}

    # per-channel budget each T/R period: channelize 15 s + decode 1 window
    cost_per_period = t_chan * ft8.T_R + t_dec
    channels = int(ft8.T_R / cost_per_period)
    baseline = 500.0                        # north-star channels
    print(json.dumps({
        "metric": "ft8_realtime_channels_per_chip",
        "value": channels,
        "unit": "channels",
        "vs_baseline": round(channels / baseline, 3),
        "device": device,
        "detail": {
            "channelizer_s_per_channel_second": round(t_chan, 10),
            "decode_s_per_window_production": round(t_dec, 5),
            "decode_s_per_window_hostfed": round(
                prod["s_per_window_hostfed"], 5),
            "decode_production_runs": [
                round(t, 5) for t in prod["runs_s_per_window"]],
            "decode_batch": prod["batch"],
            "decodes_per_window": round(prod["decodes_per_window"], 2),
            "ft8_recall_curve": curve["recall"],
            "ft8_recall_trials": curve["trials"],
            "ft8_threshold_db": curve["threshold_db"],
            "mode_decode_s_per_window": s_per_window,
            # template mix = the reference's shipped 72-line config
            # (config.ini:45-145); long FST4 costs modeled from FST4-120
            # by sample ratio
            "mixed_mode_channels_per_chip": mixed,
            "qary_host_fraction": host_frac,
        },
    }))


if __name__ == "__main__":
    main()
