"""Smoke run of the skimmer's main path on one NVIDIA GPU.

    python chip_smoke.py [--seed N]          # one card
    python chip_smoke.py --chips 4 [--seed N]

One card runs four phases in order, each at the size a skimmer operator
runs:

0. device: refuse to run unless JAX's default backend is the GPU; print the
   card's name and power limit, the JAX version and the compile cache;
1. channelizer: ``BatchChannelizer`` at 192 kHz x 256 channels over one 15 s
   window against the float64 ``SSBD`` oracle, at default matmul precision
   and at ``Precision.HIGHEST``; also its device time per channel-second;
2. App: ``App(load_config(ini))`` in this process over a 125 s file replay
   at 192 kHz with 64 decoder lines of eight modes; half the lines carry one
   protocol-exact burst in their first window, and every burst must be
   spotted once on its own line and no empty line may be spotted;
3. modes: every mode's decode at its production batch of device-resident
   windows, with one burst in the first window.

``--chips 4`` runs only the multi-device path (``dryrun_multichip``), which
compares the channel-sharded skim and the time-sharded channelizer with
one-device runs.  All IQ, messages and noise come from ``--seed``.  Any
failure exits non-zero; the last stdout line, printed only when every phase
passed, is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

FS = 192_000                 # SDR sample rate of the channelizer and App phases
LO = 14_080_000              # App source centre frequency, Hz
APP_SECONDS = 125            # App replay length
LINE_STEP = 2750             # dial spacing: a burst leaks into the line below
                             # at f0 + 2750 Hz, above every mode's search band
# decoder lines of the App phase: (mode, count) — 64 in all
APP_MIX = (("FT8", 32), ("FT4", 8), ("JS8", 8), ("JT65", 4), ("Q65-30", 4),
           ("WSPR", 4), ("FST4-60", 2), ("FST4W-120", 2))
CHAN_TOL = 2e-3              # max |audio - oracle| over full scale


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# --- synthetic traffic ------------------------------------------------------

def random_call(rng: np.random.Generator) -> str:
    letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    suffix = "".join(rng.choice(list(letters), int(rng.integers(2, 4))))
    return f"{rng.choice(['K', 'W', 'N', 'G', 'F'])}{rng.integers(10)}{suffix}"


def random_grid(rng: np.random.Generator) -> str:
    g = "ABCDEFGHIJKLMNOPQR"
    return (f"{g[rng.integers(18)]}{g[rng.integers(18)]}"
            f"{rng.integers(10)}{rng.integers(10)}")


def is_beacon(mode: str) -> bool:
    return mode == "WSPR" or mode.startswith("FST4W")


def random_message(mode: str, rng: np.random.Generator) -> str:
    if is_beacon(mode):
        dbm = int(rng.integers(0, 6)) * 10 + int(rng.choice([0, 3, 7]))
        return f"{random_call(rng)} {random_grid(rng)} {dbm}"
    if mode == "JS8":
        return f"{random_call(rng)}: {random_call(rng)} 73"
    return f"{random_call(rng)} {random_call(rng)} {random_grid(rng)}"


# audio search band each mode's decoder covers by default
F0_RANGE = {"FT8": (500, 2500), "FT4": (500, 2500), "JS8": (600, 2400),
            "JT65": (700, 1800), "Q65-30": (700, 1800),
            "WSPR": (1430, 1570)}


def f0_range(mode: str) -> tuple[int, int]:
    if mode in F0_RANGE:
        return F0_RANGE[mode]
    return (1430, 1570) if is_beacon(mode) else (910, 1090)


def snr_db(mode: str) -> float:
    """Injected SNR in 2.5 kHz: well above every mode's threshold."""
    return -20.0 if is_beacon(mode) else -12.0


def synthesize(mode: str, text: str, f0: float, n: int) -> np.ndarray:
    """One protocol-exact unit-amplitude burst in an ``n``-sample 12 kHz
    window, at the mode's standard start offset."""
    from cwsl_digi_tpu.constants import Mode
    from cwsl_digi_tpu.modes import fst4, ft4, ft8, js8, jt65, q65, wspr

    if mode == "WSPR":
        call, grid, dbm = text.split()
        return wspr.synthesize(call, grid, int(dbm), f0, window_len=n)
    if mode.startswith("FST4"):
        return fst4.synthesize(text, Mode(mode), f0, window_len=n)
    mod = {"FT8": ft8, "FT4": ft4, "JS8": js8, "JT65": jt65,
           "Q65-30": q65}[mode]
    return mod.synthesize(text, f0, window_len=n)


def tone_spacing(mode: str) -> float:
    from cwsl_digi_tpu.constants import Mode
    from cwsl_digi_tpu.modes import fst4, ft4, ft8, js8, jt65, q65, wspr

    if mode.startswith("FST4"):
        return fst4.make_spec(Mode(mode)).tone_spacing
    return {"FT8": ft8.TONE_SPACING, "FT4": ft4.SPEC.tone_spacing,
            "JS8": js8.SPEC.tone_spacing, "JT65": jt65.TONE_SPACING,
            "Q65-30": q65.TONE_SPACING, "WSPR": wspr.TONE_SPACING}[mode]


def upconvert(audio: np.ndarray, f_shift: float, fs: int) -> np.ndarray:
    """Real 12 kHz audio -> its analytic signal at ``fs``, shifted up by
    ``f_shift`` Hz: audio frequency f lands at RF offset f_shift + f."""
    from scipy import fft

    up = fs // 12_000
    n = len(audio)
    spec = fft.rfft(audio)
    full = np.zeros(n * up, np.complex128)
    full[1 : n // 2] = 2.0 * up * spec[1 : n // 2]
    z = fft.ifft(full, workers=-1)
    return z * np.exp(2j * np.pi * f_shift / fs * np.arange(n * up))


# --- spot matching -------------------------------------------------------------

def match_spots(injected: list[dict], spots: list[dict]) -> list[str]:
    """Problems found comparing spots with the injected bursts.

    ``injected``: dicts of ``line, mode, message, freq_hz, tol_hz``;
    ``spots``: dicts of ``line, mode, message, freq_hz``.  Each burst must
    be spotted exactly once on its own line and mode within ``tol_hz`` of
    its RF frequency; any other spot is false.  Empty list = pass."""
    problems = []
    used = set()
    for inj in injected:
        hits = [i for i, s in enumerate(spots)
                if s["line"] == inj["line"] and s["mode"] == inj["mode"]
                and s["message"] == inj["message"]
                and abs(s["freq_hz"] - inj["freq_hz"]) <= inj["tol_hz"]]
        if len(hits) != 1:
            problems.append(f"line {inj['line']} {inj['mode']} "
                            f"{inj['message']!r}: spotted {len(hits)} times")
        used.update(hits)
    for i, s in enumerate(spots):
        if i not in used:
            problems.append(f"false spot on line {s['line']} {s['mode']}: "
                            f"{s['message']!r} at {s['freq_hz']:.1f} Hz")
    return problems


# --- phases -----------------------------------------------------------------

def phase_device(n_chips: int) -> dict:
    import jax

    from cwsl_digi_tpu import jaxcache

    check(jax.default_backend() == "gpu",
          f"JAX backend is {jax.default_backend()!r}, not 'gpu'")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    devs = jax.devices()
    print(f"jax {jax.__version__}: {devs[0].device_kind} x{len(devs)}")
    cache = Path(jaxcache.enable())
    print(f"compile cache: {cache} "
          f"({len(list(cache.glob('*')))} entries at start)")
    check(len(devs) >= n_chips, f"need {n_chips} devices, have {len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def channelizer_error(fs: int, n_ch: int, seconds: float, n_check: int,
                      rng: np.random.Generator) -> tuple[float, float]:
    """Max |BatchChannelizer - SSBD| over ``n_check`` channels spread across
    the band, at default precision and at HIGHEST; IQ at full scale 1."""
    import jax

    from cwsl_digi_tpu.constants import SSB_BW
    from cwsl_digi_tpu.dsp.channelizer import BatchChannelizer
    from cwsl_digi_tpu.dsp.ssbd import SSBD

    n = int(seconds * fs)
    freqs = np.linspace(-fs / 2 + 1000, fs / 2 - SSB_BW - 1000, n_ch)
    iq = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    t = np.arange(n) / fs
    for f in rng.uniform(-fs / 2, fs / 2, 16):
        iq += 2.0 * np.exp(2j * np.pi * f * t)
    iq /= np.max(np.abs(np.concatenate([iq.real, iq.imag])))
    iq = iq.astype(np.complex64)
    rows = np.linspace(0, n_ch - 1, n_check).astype(int)
    gold = []
    for r in rows:
        d = SSBD(fs, SSB_BW, freqs[r])
        step = fs // 4 - (fs // 4) % d.block_size
        gold.append(np.concatenate([
            d.process(iq[i : i + step].astype(np.complex128))
            for i in range(0, n, step)]))

    def err() -> float:
        audio = np.asarray(BatchChannelizer(fs, freqs).process_window(iq))
        return max(float(np.max(np.abs(audio[r] - g)))
                   for r, g in zip(rows, gold))

    err_default = err()
    with jax.default_matmul_precision("highest"):
        return err_default, err()


def phase_channelizer(rng: np.random.Generator) -> None:
    import jax
    import jax.numpy as jnp

    from cwsl_digi_tpu.dsp.channelizer import BatchChannelizer

    n_ch, seconds = 256, 15.0
    err_default, err_highest = channelizer_error(FS, n_ch, seconds, 8, rng)
    print(f"channelizer {FS} Hz x {n_ch} ch, {seconds:g} s: max |err| vs "
          f"SSBD = {err_default:.3e} (default precision), "
          f"{err_highest:.3e} (HIGHEST); bound {CHAN_TOL:g}")
    check(err_default <= CHAN_TOL,
          f"channelizer error {err_default:.3e} > {CHAN_TOL}")

    bc = BatchChannelizer(FS, np.linspace(-90_000, 84_000, n_ch))
    n = int(seconds * FS) // bc._sub * bc._sub
    re = jnp.asarray(rng.standard_normal(n), jnp.float32)
    im = jnp.asarray(rng.standard_normal(n), jnp.float32)
    jax.block_until_ready(bc.process((re, im)))
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        out = bc.process((re, im))
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    print(f"channelizer device time: {dt * 1e3:.3f} ms per {n / FS:.2f} s "
          f"x {n_ch} ch = {dt / (n / FS) / n_ch:.3e} s per channel-second")


def build_app_traffic(rng: np.random.Generator, workdir: Path):
    """IQ file, INI and the injected-burst list of the App phase."""
    from cwsl_digi_tpu.constants import Mode, get_rx_period

    modes = [m for m, k in APP_MIX for _ in range(k)]
    modes = [modes[i] for i in rng.permutation(len(modes))]
    dials = [LO - 90_000 + LINE_STEP * i for i in range(len(modes))]
    n = APP_SECONDS * FS
    sigma = 0.05                              # noise per IQ component
    iq = (sigma * rng.standard_normal(n)
          + 1j * sigma * rng.standard_normal(n)).astype(np.complex64)
    injected, seen = [], {}
    for line, (mode, dial) in enumerate(zip(modes, dials)):
        seen[mode] = seen.get(mode, 0) + 1
        if seen[mode] > dict(APP_MIX)[mode] // 2:
            continue                          # second half of each mode: empty
        text = random_message(mode, rng)
        f0 = int(rng.integers(*f0_range(mode)))
        n_win = int(round(get_rx_period(Mode(mode)) * 12_000))
        # analytic amplitude A: SNR = A^2 / (2 sigma^2 * 2500 / FS)
        amp = np.sqrt(10 ** (snr_db(mode) / 10) * 2 * sigma**2 * 2500 / FS)
        z = amp * upconvert(synthesize(mode, text, f0, n_win), dial - LO, FS)
        iq[: len(z)] += z.astype(np.complex64)
        injected.append({"line": line, "mode": mode, "message": text,
                         "freq_hz": dial + f0, "tol_hz": tone_spacing(mode)})
    path = workdir / "band.npy"
    np.save(path, iq)
    decoders = "\n".join(f"decoder={d} {m}" for d, m in zip(dials, modes))
    # the operator callsign gives FT8 its a-priori hypotheses, as on a
    # skimmer that has one
    ini = workdir / "smoke.ini"
    ini.write_text(f"""
[radio]
source=file:{path}?sr={FS}&lo={LO}
[operator]
callsign=N0CALL
gridsquare=FN13
[decoders]
{decoders}
[logging]
loglevel=3
logimmediately=true
decodesfile={workdir / 'decodes.txt'}
statsreportinginterval=0
""")
    return ini, modes, injected


def phase_app(rng: np.random.Generator) -> None:
    from cwsl_digi_tpu.config import load_config
    from cwsl_digi_tpu.constants import Mode, get_rx_period
    from cwsl_digi_tpu.runtime.app import App
    from cwsl_digi_tpu.runtime.receiver import Status

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ini, modes, injected = build_app_traffic(rng, Path(tmp))
        app = App(load_config(ini))
        spots = []
        handle = app.spots.handle

        def capture(res, **kw):
            spot = handle(res, **kw)
            if spot is not None:
                spots.append({"line": kw["decoder_index"],
                              "mode": spot.mode.value,
                              "message": spot.message,
                              "freq_hz": kw["base_freq_hz"] + res.freq_hz})
            return spot

        app.spots.handle = capture
        t0 = time.monotonic()
        app.warmup()
        print(f"App.warmup(): {time.monotonic() - t0:.1f} s")
        # App.run's start-up with the anchor pinned at a 120 s boundary, so
        # every mode's first window starts at the replay's first sample
        t0 = time.monotonic()
        app.pool.init()
        try:
            app.setup_receivers(utc_anchor=1_800_000_000.0)
            attached = sorted(i for rx in app.receivers.values()
                              for i in rx.line_indices)
            check(attached == list(range(len(modes))),
                  f"lines not attached: "
                  f"{sorted(set(range(len(modes))) - set(attached))}")
            # windows the replay yields per line: full ones plus a flushed
            # partial one at least half filled
            want = 0
            for m in modes:
                t_r = get_rx_period(Mode(m))
                want += int(APP_SECONDS // t_r) + (
                    APP_SECONDS % t_r >= t_r / 2)
            deadline = time.monotonic() + 900
            while (app.pool.count_decoded_windows
                   + app.pool.count_dropped_stale < want):
                check(time.monotonic() < deadline,
                      f"decoded {app.pool.count_decoded_windows} of {want} "
                      "windows before the deadline")
                check(all(rx.get_status() != Status.STOPPED
                          for rx in app.receivers.values()),
                      "receiver stopped")
                time.sleep(0.2)
            wall = time.monotonic() - t0
            stale = app.pool.count_dropped_stale
        finally:
            app.cleanup()
        print(f"App run: {wall:.1f} s wall for {APP_SECONDS} s of IQ, "
              f"{len(modes)} lines, {want} windows, {stale} stale")
        check(stale == 0, f"{stale} windows dropped as stale")
        problems = match_spots(injected, spots)
        print(f"App spots: {len(spots)} found, {len(injected)} injected, "
              f"{len(problems)} problems")
        for p in problems:
            print(f"  {p}")
        check(not problems, "App spots do not match the injected bursts")


def phase_modes(rng: np.random.Generator, modes=None) -> None:
    import jax
    import jax.numpy as jnp
    from jax import monitoring

    from cwsl_digi_tpu.constants import Mode, get_rx_period
    from cwsl_digi_tpu.modes.base import get_decoder

    compile_s = [0.0]

    def on_event(event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            compile_s[0] += duration

    monitoring.register_event_duration_secs_listener(on_event)
    failed = []
    for mode in modes or Mode:
        m = mode.value
        dec = get_decoder(mode)
        batch = dec.max_device_batch
        n = int(round(get_rx_period(mode) * 12_000))
        text = random_message(m, rng)
        f0 = int(rng.integers(*f0_range(m)))
        # audio SNR in 2.5 kHz: (A^2 / 2) / (s^2 * 2500 / 6000)
        s = 1.0
        amp = np.sqrt(10 ** (snr_db(m) / 10) * 2 * s**2 * 2500 / 6000)
        burst = jnp.asarray(amp * synthesize(m, text, f0, n), jnp.float32)
        key = jax.random.key(int(rng.integers(2**31)))
        audio = s * jax.random.normal(key, (batch, n), jnp.float32)
        audio = jax.block_until_ready(audio.at[0].add(burst))
        compile_s[0] = 0.0
        t0 = time.perf_counter()
        dec.decode(audio)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = dec.decode(audio)
        run_s = time.perf_counter() - t0
        # the first-pass program (sync, demod, BP, OSD); the subtraction
        # passes of decode() run programs of their own, not measured here
        program, args = dec.device_call(audio)
        mem = program.lower(*args).compile().memory_analysis()
        got = [r.message for r in res[0]]
        extra = sum(len(r) for r in res[1:])
        ok = text in got and extra == 0
        print(f"{m:>10}: batch {batch:2d} x {n} | compile "
              f"{compile_s[0]:6.1f} s, first call {first_s:6.1f} s, run "
              f"{run_s:6.2f} s | first pass: args "
              f"{mem.argument_size_in_bytes / 2**20:8.1f} MiB, temp "
              f"{mem.temp_size_in_bytes / 2**20:8.1f} MiB | "
              f"{'ok' if ok else 'FAIL'} ({len(got)} in window 0, "
              f"{extra} elsewhere)")
        if not ok:
            failed.append(m)
    monitoring.unregister_event_duration_listener(on_event)
    check(not failed, f"modes failed: {failed}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()
    try:
        device = phase_device(args.chips)
        if args.chips == 4:
            from __graft_entry__ import dryrun_multichip

            dryrun_multichip(4, seed=args.seed)
        else:
            # one generator per phase: each phase's data depends only on
            # the seed, not on what ran before it
            for k, phase in enumerate((phase_channelizer, phase_app,
                                       phase_modes)):
                phase(np.random.default_rng([args.seed, k]))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}")
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
