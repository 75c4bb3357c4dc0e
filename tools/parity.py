"""Decode-parity harness: recall vs SNR per mode on protocol-exact signals.

The reference's decode capability is the external WSJT-X chain (jt9/wsprd/
js8 — source/DecoderPool.hpp:634-676); BASELINE.md's north star is FT8
recall >= 99% at -18 dB with zero false decodes.  This harness measures
exactly that, mode by mode, on randomized protocol-exact signals (random
standard messages, random in-band frequency, random time offset), plus:

  - false-decode rate on pure-noise windows (the reference chain's
    acceptance discipline);
  - crowded-band recall: many simultaneous FT8 signals in one window
    (the multi-pass subtraction path, jt9 -d3 analogue).

Usage:
    python tools/parity.py                       # full sweep -> PARITY_REPORT.json
    python tools/parity.py --modes FT8 WSPR --trials 25
    python tools/parity.py --fixtures            # (re)generate tests/fixtures/
    python tools/parity.py --quick               # small CI-sized sweep

Output JSON shape (PARITY_REPORT.json):
    {"modes": {"FT8": {"recall": {"-18.0": 1.0, ...}, "threshold_db": -21.3,
               "false_per_noise_window": 0.0}, ...},
     "crowded": {"n_signals": 18, "recall": 0.94}}

Runs on the ambient JAX platform (the GPU when available;
JAX_PLATFORMS=cpu for CPU).  Reference thresholds to match (practical WSJT-X limits, also
quoted in tools/sensitivity.py): FT8 -21, FT4 -17.5, WSPR -31 (deep),
JT65 -24, Q65-30 -26, FST4-60 -24.5, FST4W-120 -32.
"""

from __future__ import annotations

import argparse
import json
import string
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FIXTURE_DIR = Path(__file__).resolve().parent.parent / "tests" / "fixtures"

# Per-mode sweep configuration: SNR grid (2.5 kHz ref), f0 range the
# decoder actually searches, realistic dt jitter range (seconds).
SWEEPS: dict[str, dict] = {
    "FT8": dict(snrs=(-10, -15, -17, -18, -19, -20, -21, -22),
                f0=(400.0, 2700.0), dt=(0.1, 1.0)),
    "FT4": dict(snrs=(-10, -14, -15, -16, -17, -18),
                f0=(400.0, 2700.0), dt=(0.2, 0.8)),
    "WSPR": dict(snrs=(-20, -24, -26, -28, -29, -30, -31),
                 f0=(1420.0, 1580.0), dt=(0.5, 2.0)),
    "JT65": dict(snrs=(-18, -20, -21, -22, -23, -24),
                 f0=(700.0, 1800.0), dt=(0.5, 1.5)),
    "Q65-30": dict(snrs=(-18, -21, -23, -24, -25, -26),
                   f0=(700.0, 1800.0), dt=(0.3, 1.0)),
    # FST4 search band follows the reference's jt9 invocation: 900-1100 Hz
    # for 60/120 s, 700-1100 for 300 s (source/DecoderPool.hpp:490-534);
    # FST4W fixed 1400-1600 Hz (:536-567).  The long periods cap their
    # trial counts (max_trials): a 1800 s window is 21.6 M samples, and
    # the binomial noise floor matters less than proving the row decodes
    # (every row of the reference's jt9 invocation matrix,
    # DecoderPool.hpp:631-659, appears here).  Expected thresholds scale
    # as 10*log10(period) from FST4-60 (constant Eb/N0: tone spacing and
    # baud shrink together).
    "FST4-60": dict(snrs=(-18, -21, -23, -24, -25),
                    f0=(910.0, 1090.0), dt=(0.5, 1.5)),
    "FST4-120": dict(snrs=(-23, -25, -26, -27, -28, -29),
                     f0=(910.0, 1090.0), dt=(0.5, 1.5), max_trials=50),
    "FST4-300": dict(snrs=(-28, -30, -32, -33, -34),
                     f0=(710.0, 1090.0), dt=(0.5, 1.5), max_trials=24),
    "FST4-900": dict(snrs=(-33, -35, -37, -38, -39),
                     f0=(910.0, 1090.0), dt=(0.5, 1.5), max_trials=24),
    "FST4-1800": dict(snrs=(-36, -38, -40, -41, -42),
                      f0=(910.0, 1090.0), dt=(0.5, 1.5), max_trials=24),
    "FST4W-120": dict(snrs=(-24, -27, -29, -30, -31, -32),
                      f0=(1430.0, 1570.0), dt=(0.5, 1.5)),
    "FST4W-300": dict(snrs=(-28, -30, -32, -33, -34),
                      f0=(1430.0, 1570.0), dt=(0.5, 1.5), max_trials=24),
    "FST4W-900": dict(snrs=(-33, -35, -37, -38, -39),
                      f0=(1430.0, 1570.0), dt=(0.5, 1.5), max_trials=24),
    "FST4W-1800": dict(snrs=(-36, -38, -40, -41, -42),
                       f0=(1430.0, 1570.0), dt=(0.5, 1.5), max_trials=24),
    "JS8": dict(snrs=(-12, -16, -18, -20, -21),
                f0=(600.0, 2400.0), dt=(0.2, 0.8)),
}


# ---------------------------------------------------------------------------
# Randomized protocol-exact message + window generation
# ---------------------------------------------------------------------------

def random_call(rng: np.random.Generator) -> str:
    """Random standard amateur callsign (packable by pack_call28)."""
    letters = string.ascii_uppercase
    p = letters[rng.integers(26)] + letters[rng.integers(26)]
    d = str(rng.integers(10))
    suf = "".join(letters[rng.integers(26)] for _ in range(int(rng.integers(1, 4))))
    return p + d + suf


def random_grid(rng: np.random.Generator) -> str:
    g = "ABCDEFGHIJKLMNOPQR"
    return (g[rng.integers(18)] + g[rng.integers(18)]
            + str(rng.integers(10)) + str(rng.integers(10)))


def random_power(rng: np.random.Generator) -> int:
    """Legal WSPR power: 0..57 dBm ending in 0/3/7 (the packer clamps at
    60, so 6x values can never round-trip — a 67 here cost the -20 dB
    sweep a phantom recall failure)."""
    return int(rng.integers(0, 6)) * 10 + int(rng.choice([0, 3, 7]))


def make_trial(mode: str, rng: np.random.Generator,
               f0_range: tuple[float, float],
               dt_range: tuple[float, float]) -> tuple[np.ndarray, str]:
    """One protocol-exact clean window + its canonical expected message."""
    f0 = float(rng.uniform(*f0_range))
    dt = float(rng.uniform(*dt_range))
    if mode == "WSPR":
        from cwsl_digi_tpu.modes import wspr as m
        call, grid, dbm = random_call(rng), random_grid(rng), random_power(rng)
        return (m.synthesize(call, grid, dbm, f0, start_s=dt),
                f"{call} {grid} {dbm}")
    if mode.startswith("FST4W"):
        from cwsl_digi_tpu.constants import Mode
        from cwsl_digi_tpu.modes import fst4 as m
        call, grid, dbm = random_call(rng), random_grid(rng), random_power(rng)
        text = f"{call} {grid} {dbm}"
        return m.synthesize(text, Mode(mode), f0, start_s=dt), text
    text = f"{random_call(rng)} {random_call(rng)} {random_grid(rng)}"
    if mode == "JT65":
        from cwsl_digi_tpu.modes import jt65 as m
        return m.synthesize(text, f0, start_s=dt), text
    if mode == "Q65-30":
        from cwsl_digi_tpu.modes import q65 as m
        return m.synthesize(text, f0, start_s=dt), text
    if mode.startswith("FST4"):
        from cwsl_digi_tpu.constants import Mode
        from cwsl_digi_tpu.modes import fst4 as m
        return m.synthesize(text, Mode(mode), f0, start_s=dt), text
    if mode == "FT4":
        from cwsl_digi_tpu.modes import ft4 as m
        return m.synthesize(text, f0, start_s=dt), text
    if mode == "JS8":
        # realistic JS8 traffic is frame-exact directed/heartbeat messages
        # (free text longer than one frame spans multiple 15 s frames and
        # cannot round-trip through a single-window trial)
        from cwsl_digi_tpu.modes import js8 as m
        text = f"{random_call(rng)}: {random_call(rng)} 73"
        return m.synthesize(text, f0, start_s=dt), text
    from cwsl_digi_tpu.modes import ft8 as m
    return m.synthesize(text, f0, start_s=dt), text


def _decoded_messages(results) -> list[list[str]]:
    return [[r.message for r in rl] for rl in results]


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------

def sweep_mode(mode: str, trials: int, seed: int = 42,
               snrs=None, verbose: bool = True) -> dict:
    from cwsl_digi_tpu.modes.base import get_decoder
    from cwsl_digi_tpu.modes.gfsk import add_noise_at_snr

    cfg = SWEEPS[mode]
    snrs = list(snrs if snrs is not None else cfg["snrs"])
    trials = min(trials, cfg.get("max_trials", trials))
    rng = np.random.default_rng(seed)
    dec = get_decoder(mode)

    recall: dict[str, float] = {}
    for snr in snrs:
        wins, wants = [], []
        for _ in range(trials):
            clean, want = make_trial(mode, rng, cfg["f0"], cfg["dt"])
            wins.append(add_noise_at_snr(clean, float(snr), 12000, rng))
            wants.append(want)
        # decode in groups: a 1800 s window is 21.6 M samples, and holding
        # 24 of them device-resident alongside the decode temporaries
        # overflows device memory (the subtraction pass keeps original +
        # residual)
        wlen = len(wins[0])
        group = max(1, min(len(wins), int(2.0e8 // wlen) or 1))
        res = []
        for i in range(0, len(wins), group):
            res += _decoded_messages(dec.decode(np.stack(wins[i:i + group])))
        ok = sum(want in msgs for want, msgs in zip(wants, res))
        recall[f"{float(snr):.1f}"] = ok / trials
        if verbose:
            print(f"  {mode:10s} SNR {snr:+6.1f} dB: {ok}/{trials}"
                  f" = {ok/trials:.0%}", flush=True)

    # false decodes on pure noise (reference chain: essentially zero)
    n_noise = max(8, trials // 2)
    wlen = len(make_trial(mode, rng, cfg["f0"], cfg["dt"])[0])
    noise = rng.standard_normal((n_noise, wlen)).astype(np.float32)
    group = max(1, min(n_noise, int(2.0e8 // wlen) or 1))
    false_n = sum(
        len(msgs)
        for i in range(0, n_noise, group)
        for msgs in _decoded_messages(dec.decode(noise[i:i + group])))
    if verbose and false_n:
        print(f"  {mode}: {false_n} FALSE decodes on {n_noise} noise windows",
              flush=True)

    # 95% binomial CI half-width per recall point (thresholds are quoted
    # with stated confidence, not as bare numbers)
    ci95 = {s_: round(1.96 * float(np.sqrt(max(r * (1 - r), 0.25 / trials)
                                           / trials)), 3)
            for s_, r in recall.items()}
    return {
        "trials": trials,
        "recall": recall,
        "recall_ci95": ci95,
        "false_per_noise_window": false_n / n_noise,
        "threshold_db": _threshold(recall),
    }


def _threshold(recall: dict[str, float], level: float = 0.5) -> float | None:
    """SNR at which recall crosses `level` (linear interpolation)."""
    pts = sorted(((float(s), r) for s, r in recall.items()), reverse=True)
    prev = None
    for snr, r in pts:  # descending SNR
        if r < level:
            if prev is None:
                return None
            s_hi, r_hi = prev
            if r_hi == r:
                return s_hi
            return round(snr + (level - r) * (s_hi - snr) / (r_hi - r), 1)
        prev = (snr, r)
    return pts[-1][0] if pts else None


def sweep_crowded(n_windows: int = 6, n_signals: int = 18,
                  seed: int = 7, verbose: bool = True) -> dict:
    """Many simultaneous FT8 signals per window -> aggregate recall.

    Mirrors the reference's busy-band operating point (jt9 -d3 with
    subtraction); SNRs drawn uniform [-18, -2] dB, frequencies on a
    jittered grid so signals overlap skirts but not centers.
    """
    from cwsl_digi_tpu.modes import ft8
    from cwsl_digi_tpu.modes.base import get_decoder

    rng = np.random.default_rng(seed)
    dec = get_decoder("FT8")
    wins, wants = [], []
    wlen = int(ft8.T_R * 12000)
    for _ in range(n_windows):
        slots = np.linspace(500, 2600, n_signals) + rng.uniform(
            -30, 30, n_signals)
        acc = np.zeros(wlen)
        msgs = []
        for f0 in slots:
            text = f"{random_call(rng)} {random_call(rng)} {random_grid(rng)}"
            snr = float(rng.uniform(-18, -2))
            dt = float(rng.uniform(0.1, 1.0))
            clean = ft8.synthesize(text, float(f0), start_s=dt)
            amp = 10.0 ** (snr / 20.0)  # relative to the common noise floor
            acc += amp * clean
            msgs.append(text)
        # shared noise floor: density such that a unit-amplitude GFSK
        # burst (power 0.5) measures 0 dB in the 2.5 kHz reference bw,
        # so each signal's SNR is exactly its amp in dB (amp=10^(snr/20))
        noise_power = 0.5 / 2500.0 * (12000 / 2.0)
        noise = rng.standard_normal(wlen) * np.sqrt(noise_power)
        wins.append(acc + noise)
        wants.append(msgs)
    res = _decoded_messages(dec.decode(np.stack(wins)))
    total = sum(len(m) for m in wants)
    got = sum(sum(w in msgs for w in want) for want, msgs in zip(wants, res))
    if verbose:
        print(f"  crowded FT8: {got}/{total} signals decoded "
              f"({n_signals}/window x {n_windows})", flush=True)
    return {"n_windows": n_windows, "n_signals": n_signals,
            "total_signals": total, "decoded": got,
            "recall": round(got / total, 3)}


# ---------------------------------------------------------------------------
# Committed fixtures (regression inputs decoupled from the live synth code)
# ---------------------------------------------------------------------------

FIXTURES = [
    # (name, mode, message-or-None(=use args), snr_db, f0, dt, seed)
    ("ft8_m10db", "FT8", "K1ABC W9XYZ EN37", -10.0, 1500.0, 0.5, 1),
    ("ft8_m18db", "FT8", "CQ DL7ACA JO40", -18.0, 850.0, 0.9, 2),
    ("ft8_m21db", "FT8", "G4ABC K1ABC RR73", -21.0, 2210.0, 0.3, 3),
    ("ft4_m15db", "FT4", "K1ABC W9XYZ EN37", -15.0, 1200.0, 0.4, 4),
    ("wspr_m28db", "WSPR", "K1ABC FN42 30", -28.0, 1512.3, 1.2, 5),
    ("jt65_m22db", "JT65", "K1ABC W9XYZ EN37", -22.0, 1270.5, 1.0, 6),
    ("q65_m24db", "Q65-30", "K1ABC W9XYZ EN37", -24.0, 1000.0, 0.6, 7),
    ("fst4_60_m23db", "FST4-60", "K1ABC W9XYZ EN37", -23.0, 1000.0, 1.0, 8),
    ("js8_m18db", "JS8", "CQCQ K1ABC", -18.0, 1500.0, 0.5, 9),
]


def synth_named(mode: str, message: str, f0: float, dt: float) -> np.ndarray:
    if mode == "WSPR":
        from cwsl_digi_tpu.modes import wspr as m
        call, grid, dbm = message.split()
        return m.synthesize(call, grid, int(dbm), f0, start_s=dt)
    if mode.startswith("FST4"):
        from cwsl_digi_tpu.constants import Mode
        from cwsl_digi_tpu.modes import fst4 as m
        return m.synthesize(message, Mode(mode), f0, start_s=dt)
    import importlib
    m = importlib.import_module(
        "cwsl_digi_tpu.modes." + mode.split("-")[0].lower())
    return m.synthesize(message, f0, start_s=dt)


def write_fixtures() -> None:
    from cwsl_digi_tpu.modes.gfsk import add_noise_at_snr
    from cwsl_digi_tpu.utils.wav import prepare_audio, write_wav

    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    manifest = []
    for name, mode, message, snr, f0, dt, seed in FIXTURES:
        rng = np.random.default_rng(seed)
        clean = synth_named(mode, message, f0, dt)
        audio = add_noise_at_snr(clean, snr, 12000, rng)
        path = FIXTURE_DIR / f"{name}.wav"
        write_wav(path, prepare_audio(audio, 0.90))
        manifest.append({"file": path.name, "mode": mode, "message": message,
                         "snr_db": snr, "f0_hz": f0, "dt_s": dt})
        print(f"  wrote {path.name} ({path.stat().st_size//1024} KiB)")
    (FIXTURE_DIR / "manifest.json").write_text(
        json.dumps(manifest, indent=1))


# ---------------------------------------------------------------------------

def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", nargs="*", default=None)
    ap.add_argument("--trials", type=int, default=25)
    ap.add_argument("--quick", action="store_true",
                    help="tiny sweep (CI-sized)")
    ap.add_argument("--fixtures", action="store_true",
                    help="regenerate tests/fixtures/ and exit")
    ap.add_argument("--no-crowded", action="store_true")
    ap.add_argument("--merge", action="store_true",
                    help="update only the swept modes inside an existing "
                         "--out report (patch sweeps)")
    ap.add_argument("--out", default="PARITY_REPORT.json")
    args = ap.parse_args()

    from cwsl_digi_tpu import jaxcache
    jaxcache.enable()

    if args.fixtures:
        write_fixtures()
        return

    import jax
    modes = args.modes or list(SWEEPS)
    trials = 8 if args.quick else args.trials
    report: dict = {"platform": jax.devices()[0].platform,
                    "trials": trials, "modes": {}}
    if args.merge and Path(args.out).exists():
        report = json.loads(Path(args.out).read_text())
        report["platform"] = jax.devices()[0].platform
    for mode in modes:
        print(f"== {mode} ==", flush=True)
        snrs = SWEEPS[mode]["snrs"][-3:] if args.quick else None
        report["modes"][mode] = sweep_mode(mode, trials, snrs=snrs)
    if not args.no_crowded and (args.modes is None or "FT8" in modes):
        print("== crowded band ==", flush=True)
        report["crowded"] = sweep_crowded(
            n_windows=2 if args.quick else 6)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
