"""False decodes on pure noise, per mode, with the decoders the App builds.

    python tools/noise_audit.py --modes FT8 FT4 JS8 --windows 12000
    python tools/noise_audit.py --modes FT8 --my-call N0CALL
    python tools/noise_audit.py --modes FT8 --only 517 9031   # re-decode two
    python tools/noise_audit.py --modes FT8 --windows 0 --recall-snrs -21 -22

Window ``w`` of a mode is white Gaussian noise from numpy's generator
seeded with ``(seed, w)``, made on the host, so every backend decodes the
same windows: a window flagged on the GPU can be re-decoded on the CPU
with ``--only``.  The decoders take the App's defaults (decodedepth 3,
highestdecodefreq 3000 Hz, wsprcycles 3000); ``--my-call`` gives FT8 its
a-priori hypotheses as an operator callsign does.  ``--ungated`` turns off
the GFSK engine's weak-candidate gates (``ModeSpec.sync_min``,
``weak_sync``, ``snr_floor_db``) to show what they remove, and
``--recall-snrs`` what they cost: recall on ``tools/parity.py``'s random
protocol-exact trials at those SNRs.  One line per mode: false decodes over
windows, each as (window, message, SNR), then the recall.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def app_decoder(mode, my_call: str = "", ungated: bool = False):
    """A decoder configured as ``App``'s decoder factory configures it."""
    from cwsl_digi_tpu.constants import Mode, is_mode_fst4
    from cwsl_digi_tpu.modes.base import get_decoder
    from cwsl_digi_tpu.modes.gfsk_engine import GFSKDecoder

    mode = Mode(mode)
    if mode == Mode.FT8:
        kw = dict(my_call=my_call, depth=3, fmax_hz=3000.0)
    elif mode == Mode.FT4:
        kw = dict(depth=3, fmax_hz=3000.0)
    elif mode == Mode.WSPR:
        kw = dict(cycles=3000)
    elif mode in (Mode.JS8, Mode.JT65, Mode.Q65_30) or is_mode_fst4(mode):
        kw = dict(fmax_hz=3000.0)
    else:
        kw = {}
    dec = get_decoder(mode, **kw)
    if ungated and isinstance(dec, GFSKDecoder):
        # before its first decode, so every pass takes the ungated spec
        dec.spec = dataclasses.replace(
            dec.spec, sync_min=-1, weak_sync=-1, snr_floor_db=-99.0)
    return dec


def noise_window(seed: int, w: int, n: int) -> np.ndarray:
    return np.random.default_rng([seed, w]).standard_normal(n, np.float32)


def audit(mode, windows, seed: int, my_call: str = "",
          ungated: bool = False) -> list[tuple[int, str, float]]:
    """(window, message, SNR) of every decode on the given noise windows."""
    from cwsl_digi_tpu.constants import get_rx_period

    dec = app_decoder(mode, my_call, ungated)
    n = int(round(get_rx_period(dec.mode) * 12_000))
    batch = getattr(dec, "max_device_batch", 8)
    false = []
    for i in range(0, len(windows), batch):
        ws = windows[i : i + batch]
        audio = np.stack([noise_window(seed, w, n) for w in ws])
        for w, res in zip(ws, dec.decode(audio)):
            false += [(w, r.message, r.snr_db) for r in res]
    return false


def recall(mode, snrs, trials: int, seed: int, my_call: str = "",
           ungated: bool = False) -> tuple[int, dict[float, int]]:
    """Trials per SNR (``trials`` rounded up to whole device batches, so
    no other program shape compiles) and the decoded ones at each SNR (dB
    in 2.5 kHz)."""
    from cwsl_digi_tpu.modes.gfsk import add_noise_at_snr
    from tools.parity import SWEEPS, make_trial

    dec = app_decoder(mode, my_call, ungated)
    batch = getattr(dec, "max_device_batch", 8)
    trials = -(-trials // batch) * batch
    cfg = SWEEPS[dec.mode.value]
    hits = {}
    for snr in snrs:
        rng = np.random.default_rng([seed, 1, round(-10 * snr)])
        trials_ = [make_trial(dec.mode.value, rng, cfg["f0"], cfg["dt"])
                   for _ in range(trials)]
        audio = np.stack([add_noise_at_snr(clean, snr, 12_000, rng)
                          for clean, _ in trials_]).astype(np.float32)
        hits[snr] = sum(want in [r.message for r in res]
                        for (_, want), res in zip(trials_, dec.decode(audio)))
    return trials, hits


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--modes", nargs="+", default=["FT8", "FT4", "JS8"])
    ap.add_argument("--windows", type=int, default=1200,
                    help="noise windows per mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--my-call", default="",
                    help="operator callsign: FT8 a-priori hypotheses")
    ap.add_argument("--ungated", action="store_true",
                    help="without the weak-candidate gates")
    ap.add_argument("--only", type=int, nargs="+",
                    help="decode only these window indices")
    ap.add_argument("--recall-snrs", type=float, nargs="*", default=[],
                    help="also measure recall at these SNRs")
    ap.add_argument("--trials", type=int, default=64,
                    help="signal trials per recall SNR")
    args = ap.parse_args()

    import jax

    from cwsl_digi_tpu import jaxcache

    jaxcache.enable()
    windows = args.only or list(range(args.windows))
    platform = jax.devices()[0].platform
    for m in args.modes:
        t0 = time.perf_counter()
        false = audit(m, windows, args.seed, args.my_call, args.ungated)
        print(f"{m:>10} {platform} my_call={args.my_call or '-'} "
              f"gates={'off' if args.ungated else 'on'} seed={args.seed}: "
              f"{len(false)} false in {len(windows)} noise windows "
              f"({time.perf_counter() - t0:.0f} s) {false}", flush=True)
        if args.recall_snrs:
            n, hits = recall(m, args.recall_snrs, args.trials, args.seed,
                             args.my_call, args.ungated)
            print(f"{m:>10} recall: " + ", ".join(
                f"{snr:g} dB {k}/{n}" for snr, k in hits.items()),
                  flush=True)


if __name__ == "__main__":
    main()
