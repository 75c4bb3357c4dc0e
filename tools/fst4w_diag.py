"""FST4W-120 miss diagnosis: sync acquisition vs decoder failure.

For each undetected trial at a given SNR, classify the failure:
  - sync_miss:   no candidate slot landed within tolerance of the true
                 (t0_hop, f0_bin) — the candidate search never saw it;
  - decode_fail: a candidate was on target but BP+OSD could not validate
                 a codeword — the LLR/decoder chain is the limit.

This tells us which lever closes the remaining FST4W-120 gap:
candidate grid / sync scoring vs bit metrics / OSD.

Usage: python tools/fst4w_diag.py --snrs -30,-30.5,-31 --trials 16
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="FST4W-120")
    ap.add_argument("--snrs", default="-30,-30.5,-31")
    ap.add_argument("--trials", type=int, default=16)
    args = ap.parse_args()

    from cwsl_digi_tpu.constants import WAVE_SR, Mode
    from cwsl_digi_tpu.modes import fst4
    from cwsl_digi_tpu.modes.gfsk import add_noise_at_snr

    mode = Mode(args.mode)
    dec = fst4.FST4Decoder(mode)
    spec = dec.spec
    is_w = "W" in args.mode
    want = "K1ABC FN42 30" if is_w else "CQ K1ABC FN42"

    rng = np.random.default_rng(7)
    report = {}
    for snr in [float(s) for s in args.snrs.split(",")]:
        rows = []
        for t in range(args.trials):
            f0 = float(rng.uniform(spec.fmin_hz + 5, spec.fmax_hz - 10))
            start_s = float(rng.uniform(0.5, 1.5))
            clean = fst4.synthesize(want, mode, f0, start_s=start_s)
            audio = add_noise_at_snr(clean, snr, rng=rng)
            # truth on the candidate grid (decode_program's coordinates:
            # t0 counted in os_t-fine hops incl. padding offset removed
            # at output; f0_bin in os_f-fine bins)
            true_t0 = start_s * WAVE_SR / spec.hop  # hops, output coords
            true_f0 = f0 / spec.bin_hz              # fine bins
            out = dec.decode_arrays(audio.astype(np.float32)[None, :])
            msgs = []
            n_payload = dec._crc_mat.shape[0]
            for wi, k in np.argwhere(out["valid"]):
                payload = out["payload"][wi, k, :n_payload]
                msgs.append(dec.unpack(payload.astype(np.uint8)))
            hit = want in msgs
            # was the true cell among the candidate slots?
            t0s = out["t0_hop"][0].astype(np.float64)
            f0s = out["f0_bin"][0].astype(np.float64)
            d_t = np.abs(t0s - true_t0)
            d_f = np.abs(f0s - true_f0)
            on_target = (d_t <= 2.0) & (d_f <= 2.0)
            near = bool(np.any((d_t <= 4) & (d_f <= 4)))
            rows.append({
                "snr": snr, "hit": hit,
                "cand_on_target": bool(np.any(on_target)),
                "cand_near": near,
                "best_dt_df": [round(float(d_t.min()), 2),
                               round(float(d_f[np.argmin(d_t)]), 2)],
            })
        n = len(rows)
        hits = sum(r["hit"] for r in rows)
        miss = [r for r in rows if not r["hit"]]
        sync_miss = sum(1 for r in miss if not r["cand_on_target"])
        report[str(snr)] = {
            "recall": round(hits / n, 3),
            "misses": len(miss),
            "sync_misses": sync_miss,
            "decode_fails": len(miss) - sync_miss,
        }
        print(json.dumps({str(snr): report[str(snr)]}), flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
