"""Rebuild a PARITY_REPORT-shaped JSON from a parity sweep's console log.

Safety net for long sweeps: tools/parity.py only writes its report at
the very end, so a run interrupted hours in (wall-clock limits) would
lose every completed mode.  This parses the
per-SNR progress lines ("  MODE  SNR  -xx.x dB: k/N = p%") back into the
same JSON shape, marking the artifact as log-derived.

Usage: python tools/parity_logparse.py LOGFILE [--out PARITY_REPORT.json]
       [--merge]   # update only the parsed modes in an existing report
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

LINE = re.compile(
    r"^\s+(\S+)\s+SNR\s+([-+]\d+(?:\.\d+)?) dB:\s+(\d+)/(\d+)")
FALSE = re.compile(r"^\s+(\S+): (\d+) FALSE decodes on (\d+) noise")


def parse(path: str) -> dict:
    from parity import _threshold

    modes: dict[str, dict] = {}
    for line in Path(path).read_text().splitlines():
        m = LINE.match(line)
        if m:
            mode, snr, ok, n = m.group(1), float(m.group(2)), int(
                m.group(3)), int(m.group(4))
            d = modes.setdefault(mode, {"trials": n, "recall": {},
                                        "false_per_noise_window": 0.0})
            d["recall"][f"{snr:.1f}"] = ok / n
            d["trials"] = max(d["trials"], n)
            continue
        m = FALSE.match(line)
        if m:
            mode, false_n, n_noise = m.group(1), int(m.group(2)), int(
                m.group(3))
            if mode in modes:
                modes[mode]["false_per_noise_window"] = false_n / n_noise
    for d in modes.values():
        d["threshold_db"] = _threshold(d["recall"])
    return modes


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("log")
    ap.add_argument("--out", default="PARITY_REPORT.json")
    ap.add_argument("--merge", action="store_true")
    args = ap.parse_args()

    modes = parse(args.log)
    report = {"modes": {}, "source": "log-derived (tools/parity_logparse)"}
    if args.merge and Path(args.out).exists():
        report = json.loads(Path(args.out).read_text())
    report.setdefault("modes", {}).update(modes)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"wrote {args.out}: {sorted(modes)}")


if __name__ == "__main__":
    main()
