"""Application driver: config -> receivers -> pool -> reporters -> supervise.

The reference's main() (source/CWSL_DIGI.cpp:523-1257): parse config, build
objects, launch cadence threads, then a 1 s supervision loop that reaps dead
receivers, re-attaches FINISHED decoders (band rotation support,
CHANGELOG.txt:23) and emits the RBN status datagram every 60 s
(:1204-1253).  Run with::

    python -m cwsl_digi_tpu.runtime.app --configfile config.ini \
        [section.key=value ...]

Source selection: each decoder line's ``sharedmem`` field picks a capture
source; sources are configured in the INI as ``[radio] source<N>=spec``
(spec grammar: sdr/source.open_source).  With no sources configured the app
probes CWSL-style POSIX shared memories (sdr/shm.find_band), mirroring the
reference's discovery (source/CWSL_Utils.hpp:27-53).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

from cwsl_digi_tpu.config import Config, load_config
from cwsl_digi_tpu.constants import Mode, get_rx_period
from cwsl_digi_tpu.report.rbn import DecoderEntry, RBNHandler
from cwsl_digi_tpu.report.pskreporter import PSKReporter
from cwsl_digi_tpu.report.wsprnet import WSPRNet
from cwsl_digi_tpu.report.spot import SpotHandler
from cwsl_digi_tpu.runtime.decoderpool import DecoderPool
from cwsl_digi_tpu.runtime.receiver import Receiver, Status
from cwsl_digi_tpu.runtime.scheduler import CadenceScheduler
from cwsl_digi_tpu.sdr.source import open_source
from cwsl_digi_tpu.stats import Stats
from cwsl_digi_tpu.utils.logging import LogLevel, ScreenPrinter
from cwsl_digi_tpu.utils.timeutils import next_period_boundary
from cwsl_digi_tpu.version import PROGRAM_NAME, __version__


class App:
    def __init__(self, cfg: Config, max_runtime_s: float | None = None) -> None:
        from cwsl_digi_tpu import jaxcache

        jaxcache.enable()
        self.cfg = cfg
        self.max_runtime_s = max_runtime_s
        self.printer = ScreenPrinter(
            level=LogLevel(int(cfg.get("logging", "loglevel"))),
            logfile=cfg.get("logging", "logfile") or None,
            immediate=bool(cfg.get("logging", "logimmediately")),
        )
        self._terminate = False
        self._warm = False
        self.receivers: dict[str, Receiver] = {}
        self.stats = Stats(num_decoders=len(cfg.decoders))

        reporters = []
        self.rbn = None
        if cfg.get("reporting", "pskreporter"):
            reporters.append(PSKReporter(
                cfg.get("operator", "callsign"),
                cfg.get("operator", "gridsquare"),
                log=self.printer.debug,
            ))
        if cfg.get("reporting", "rbn"):
            self.rbn = RBNHandler(
                cfg.get("operator", "callsign"),
                cfg.get("operator", "gridsquare"),
                ip=cfg.get("reporting", "aggregatorip"),
                port=int(cfg.get("reporting", "aggregatorport")),
            )
            reporters.append(self.rbn)
        if cfg.get("reporting", "wsprnet"):
            reporters.append(WSPRNet(
                cfg.get("operator", "gridsquare"),
                cfg.get("operator", "callsign"),
                log=self.printer.warn,
            ))

        self.spots = SpotHandler(
            reporters=reporters,
            stats=self.stats,
            ignored_calls=self._load_ignored(),
            decodes_file=cfg.get("logging", "decodesfile") or None,
            bad_msg_log=cfg.get("logging", "badmsglog") or None,
            log=self.printer.info,
        )
        keep_wav_dir = None
        if cfg.get("wsjtx", "keepwav"):
            keep_wav_dir = cfg.get("wsjtx", "temppath") or "keepwav"

        # decodedepth (config.ini:213-215, jt9 -d flag), wsprcycles
        # (config.ini:217-222, wsprd -C flag) and highestdecodefreq
        # (jt9 -H, DecoderPool.hpp:636-651) map to native decoder knobs
        depth = max(1, min(3, int(cfg.get("wsjtx", "decodedepth"))))
        cycles = int(cfg.get("wsjtx", "wsprcycles"))
        fmax = float(cfg.get("wsjtx", "highestdecodefreq"))

        def decoder_factory(mode):
            from cwsl_digi_tpu.constants import Mode as _M, is_mode_fst4
            from cwsl_digi_tpu.modes.base import get_decoder

            # FT8 gets a-priori hypotheses seeded with the operator callsign
            # (reference AP flags, source/DecoderPool.hpp:466-469)
            if mode == _M.FT8:
                return get_decoder(mode, my_call=cfg.get("operator", "callsign"),
                                   depth=depth, fmax_hz=fmax)
            if mode == _M.FT4:
                return get_decoder(mode, depth=depth, fmax_hz=fmax)
            if mode == _M.WSPR:
                # wsprd takes no -H; its band is the WSPR sub-band
                return get_decoder(mode, cycles=cycles)
            if mode in (_M.JS8, _M.JT65, _M.Q65_30) or is_mode_fst4(mode):
                return get_decoder(mode, fmax_hz=fmax)
            # FST4W keeps the fixed 1400-1600 Hz band (jt9 -L/-H override)
            return get_decoder(mode)

        self.pool = DecoderPool(
            # The reference's heuristic sizes OS processes (one jt9 per ~5
            # channels, CWSL_DIGI.cpp:856-868); here a job is one batched
            # device call for ALL channels of a (mode, window), so workers
            # only pipeline host work against the single device — beyond a
            # handful they are pure GIL/scheduler churn (measured in the
            # 512-channel live soak: ~100 threads inflated decode walls
            # ~3x).  The config heuristic still feeds capacity-planning
            # parity; the pool clamps it to the useful range.
            num_workers=min(cfg.num_decode_slots(), 4),
            max_long_workers=max(1, cfg.max_long_slots()),
            max_data_age_factor=float(cfg.get("wsjtx", "maxdataage")),
            on_result=self._on_result,
            log=self.printer.debug,
            keep_wav_dir=keep_wav_dir,
            decoder_factory=decoder_factory,
            wav_scale_ft=float(cfg.get("wsjtx", "ftaudioscalefactor")),
            wav_scale_wspr=float(cfg.get("wsjtx", "wspraudioscalefactor")),
        )

    def _load_ignored(self) -> list[str]:
        # reference: reporting.ignoredcalls multitoken list
        # (source/CWSL_DIGI.cpp:549, config.ini:247-251)
        raw = self.cfg.get("reporting", "ignoredcalls")
        if isinstance(raw, str):
            return raw.upper().split()
        return [str(c).upper() for c in raw]

    def _on_result(self, job, ci, res):
        # `printjt9output` analogue: echo decodes in jt9/wsprd text format
        # (reference: CWSL_DIGI.cpp:570)
        if self.cfg.get("logging", "printjt9output"):
            from cwsl_digi_tpu.report import jt9format

            if res.mode == Mode.WSPR:
                line = jt9format.format_wsprd(res, job.epoch_time,
                                              job.base_freqs[ci],
                                              drift=int(round(res.drift_hz)))
            else:
                line = jt9format.format_jt9(res, job.epoch_time)
            self.printer.info(line)
        wspr_call = ""
        if job.wspr_callsigns:
            wspr_call = job.wspr_callsigns[ci]
        self.spots.handle(
            res,
            base_freq_hz=job.base_freqs[ci],
            decoder_index=job.decoder_indices[ci],
            epoch_time=job.epoch_time,
            wspr_reporter_call=wspr_call,
        )

    # -- construction -------------------------------------------------------

    def _source_spec_for(self, smnum: int) -> str | None:
        key = f"source{smnum}" if smnum >= 0 else "source"
        try:
            return self.cfg.get("radio", key)
        except KeyError:
            return None

    def _group_lines(self, warn: bool = True) -> dict[str, list[int]]:
        """Decoder-line indices grouped by capture-source spec."""
        groups: dict[str, list[int]] = {}
        for i, line in enumerate(self.cfg.decoders):
            spec = self._source_spec_for(line.smnum)
            if spec is None:
                from cwsl_digi_tpu.sdr.shm import find_band

                name = find_band(line.calibrated_freq, line.smnum)
                if name is None:
                    if warn:
                        self.printer.warn(
                            f"no capture source covers {line.freq} Hz — "
                            f"skipped (will retry, reference behavior "
                            f"CWSL_DIGI.cpp:109-113)"
                        )
                    continue
                spec = f"shm:{name}"
            groups.setdefault(spec, []).append(i)
        return groups

    def setup_receivers(self, utc_anchor: float) -> None:
        """Group decoder lines by capture source and build Receivers
        (reference: setupDecoder loop, source/CWSL_DIGI.cpp:1181-1188)."""
        groups = self._group_lines()

        for spec, idxs in groups.items():
            if spec in self.receivers:
                continue
            lines = [self.cfg.decoders[i] for i in idxs]
            try:
                src = open_source(spec)
            except Exception as e:
                self.printer.err(f"cannot open source {spec}: {e}")
                continue
            live = spec.startswith(("shm:", "tcp:")) or getattr(
                src, "live", False)
            try:
                rx = Receiver(src, lines, self.pool, utc_anchor=utc_anchor,
                              log=self.printer.print, line_indices=idxs,
                              align_live=live)
            except ValueError as e:
                # e.g. decoder tuned outside the source's band — log and
                # retry on the re-attach cadence (reference behavior for
                # findBand failure, CWSL_DIGI.cpp:109-113)
                self.printer.err(f"cannot attach decoders to {spec}: {e}")
                src.close()
                continue
            # compile the channelize/framing programs FIRST, then take the
            # anchor: compiling after anchoring would eat into the first
            # capture windows (measured 13-24 s first-batch stalls in the
            # 256-channel soak before this ordering)
            t0 = time.monotonic()
            rx.warm()
            dt_warm = time.monotonic() - t0
            if dt_warm > 1.0:
                self.printer.info(
                    f"receiver programs compiled in {dt_warm:.0f} s")
            if live:
                rx.set_anchor(next_period_boundary(15.0))
            rx.init()
            self.receivers[spec] = rx
            self.printer.info(
                f"receiver up: {spec} ({len(lines)} decoders, "
                f"SR {src.sample_rate}, LO {src.lo_freq})"
            )

    # -- run ----------------------------------------------------------------

    def warmup(self) -> None:
        """Pre-compile every configured mode's decode program.

        First compiles can take minutes; doing them before receivers start
        means no capture window ever waits behind a compile and gets shed
        as stale.  Runs once: :meth:`run` calls it, and so may its caller
        beforehand.
        """
        import numpy as np

        if self._warm:
            return

        from cwsl_digi_tpu.constants import WAVE_SR

        # receivers submit one batch per (capture source, mode), so warm
        # exactly those shapes
        shapes: set[tuple] = set()
        for spec, idxs in self._group_lines(warn=False).items():
            counts: dict = {}
            for i in idxs:
                m = self.cfg.decoders[i].mode
                counts[m] = counts.get(m, 0) + 1
            shapes.update(counts.items())
        from cwsl_digi_tpu.modes.base import warmup_window

        for mode, n_ch in sorted(shapes, key=lambda kv: (kv[0].value, kv[1])):
            t0 = time.monotonic()
            dec = self.pool._decoder_factory(mode)
            n = int(get_rx_period(mode) * WAVE_SR)
            # one channel carries a strong signal: a successful pass-1
            # decode is what triggers the pass-2 / subtraction / OSD
            # program compiles — warming up on silence left them to fire
            # inside the first live window that carried a signal
            batch = np.zeros((n_ch, n), np.float32)
            try:
                w = warmup_window(mode)
                m = min(len(w), n)
                batch[0, :m] = w[:m]
            except NotImplementedError:
                pass
            dec.decode(batch)
            if hasattr(dec, "warm_passes"):
                # compile every inter-pass helper arity (tuple-of-outs
                # jit signatures decode() can reach live; see
                # GFSKDecoder.warm_passes)
                dec.warm_passes(n_ch)
            self.printer.info(
                f"warmup: {mode.value} x{n_ch} decode program compiled in "
                f"{time.monotonic() - t0:.0f} s"
            )
        self._warm = True

    def run(self) -> None:
        self.printer.info(f"{PROGRAM_NAME} {__version__} starting")
        self.warmup()
        self.pool.init()
        # anchor stream time at the next UTC boundary of the fastest period
        anchor = next_period_boundary(15.0)
        self.setup_receivers(utc_anchor=anchor)

        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGINT,
                          lambda *_: setattr(self, "_terminate", True))
        started = time.monotonic()
        stats_interval = float(self.cfg.get("logging", "statsreportinginterval"))
        # one timer wheel for the supervision cadences (reference spreads
        # these over the main loop tick counter, CWSL_DIGI.cpp:1204-1253)
        sched = CadenceScheduler()
        # re-attach finished/unattached decoders every ~10 s (:1217-1226)
        sched.subscribe(10.0, lambda _b: self.setup_receivers(
            utc_anchor=next_period_boundary(15.0)))
        if self.rbn is not None:
            # RBN status every 60 s (:1230-1252)
            sched.subscribe(60.0, lambda _b: self._rbn_status())
        if stats_interval:
            sched.subscribe(stats_interval, lambda _b: self._report_stats())
        while not self._terminate:
            time.sleep(1.0)
            now = time.monotonic()
            if self.max_runtime_s and now - started > self.max_runtime_s:
                break
            self._reap_dead_receivers()
            sched.run_once()
        self.cleanup()

    def _reap_dead_receivers(self) -> None:
        """Reap STOPPED receivers (reference: CWSL_DIGI.cpp:1206-1216), and
        FINISHED receivers of LIVE sources so the 10 s re-attach cadence
        rebuilds them (the reference re-setups FINISHED decoders,
        CWSL_DIGI.cpp:1217-1226 — band-rotation support).  A FINISHED file
        replay is terminal: rebuilding it would replay the file forever."""
        for spec, rx in list(self.receivers.items()):
            status = rx.get_status()
            live = spec.startswith(("shm:", "tcp:"))
            if status == Status.STOPPED or (
                    status == Status.FINISHED and live):
                self.printer.warn(f"receiver {spec} {status.value} — reaping")
                rx.terminate()
                del self.receivers[spec]

    def _rbn_status(self) -> None:
        entries = [
            DecoderEntry(line.mode.value, line.freq)
            for line in self.cfg.decoders
        ]
        self.rbn.handle_status(
            int(self.cfg.get("wsjtx", "highestdecodefreq")), entries
        )

    def _report_stats(self) -> None:
        labels = [f"{l.freq} {l.mode.value}" for l in self.cfg.decoders]
        # per-decoder status from the owning receiver (reference status
        # column incl. FINISHED->'Inactive', CWSL_DIGI.cpp:486-510)
        statuses = ["Unattached"] * len(self.cfg.decoders)
        for rx in self.receivers.values():
            s = rx.get_status()
            label = "Inactive" if s == Status.FINISHED else s.value
            for idx in rx.line_indices:
                statuses[idx] = label
        self.printer.info(
            "\n" + self.stats.table(labels, statuses)
            + f"\nDecode workers busy: {self.pool.busy_fraction():.0%}"
            f"  windows decoded: {self.pool.count_decoded_windows}"
            f"  stale dropped: {self.pool.count_dropped_stale}"
        )

    def cleanup(self) -> None:
        """Reference teardown order (source/CWSL_DIGI.cpp:454-468):
        receivers/decoders -> pool -> reporters -> printer last."""
        for rx in self.receivers.values():
            rx.terminate()
        self.pool.drain(timeout=10.0)
        self.pool.terminate()
        for rep in self.spots.reporters:
            flush = getattr(rep, "flush", None)
            if flush:
                flush()
            rep.terminate()
        self.printer.info("shutdown complete")
        self.printer.terminate()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog=PROGRAM_NAME)
    ap.add_argument("--configfile", default=None)
    ap.add_argument("--max-runtime", type=float, default=None,
                    help="exit after N seconds (testing)")
    ap.add_argument("overrides", nargs="*", help="section.key=value")
    args = ap.parse_args(argv)
    cfg = load_config(args.configfile, args.overrides)
    if not cfg.decoders:
        print("no decoders configured", file=sys.stderr)
        return 2
    app = App(cfg, max_runtime_s=args.max_runtime)
    app.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
