"""Runtime layer: shm ring, sources, scheduler, pool, receiver end-to-end."""

import time

import numpy as np
import pytest

from cwsl_digi_tpu.config import DecoderLine
from cwsl_digi_tpu.constants import Mode
from cwsl_digi_tpu.modes import ft8
from cwsl_digi_tpu.modes.base import DecodeResult
from cwsl_digi_tpu.modes.gfsk import gfsk_modulate_iq
from cwsl_digi_tpu.runtime.decoderpool import DecodeJob, DecoderPool
from cwsl_digi_tpu.runtime.receiver import Receiver, Status
from cwsl_digi_tpu.runtime.scheduler import CadenceScheduler
from cwsl_digi_tpu.sdr.shm import ShmSource, ShmWriter, find_band, shm_name
from cwsl_digi_tpu.sdr.source import ReplaySource, SyntheticSource, open_source


# ---------------------------------------------------------------------------
# Shared-memory ring (reference contract: SharedMemory.h/CWSL_Utils.hpp)
# ---------------------------------------------------------------------------
def test_shm_roundtrip():
    name = "testCWSLring0"
    w = ShmWriter(name, sample_rate=96_000, block_in_samples=1024,
                  l0=14_085_000, num_blocks=8)
    try:
        src = ShmSource(name)
        assert src.sample_rate == 96_000
        assert src.block_size == 1024
        assert src.lo_freq == 14_085_000
        blocks = [np.full(1024, i + 1j * i, np.complex64) for i in range(3)]
        for b in blocks:
            w.write_block(b)
        for i in range(3):
            got = src.read_block(timeout=0.5)
            np.testing.assert_array_equal(got, blocks[i])
        assert src.read_block(timeout=0.05) is None  # no more data
        src.close()
    finally:
        w.close()


def test_shm_overrun_skips_to_oldest():
    name = "testCWSLring1"
    w = ShmWriter(name, 48_000, 256, 7_000_000, num_blocks=4)
    try:
        src = ShmSource(name)
        for i in range(10):   # laps the 4-block ring
            w.write_block(np.full(256, i, np.complex64))
        got = src.read_block(timeout=0.5)
        assert got[0].real >= 6  # skipped to oldest safe block
        src.close()
    finally:
        w.close()


def test_find_band():
    # reference: findBand probes CWSL<idx>Band names (CWSL_Utils.hpp:27-53)
    w = ShmWriter(shm_name(2), 192_000, 512, 14_085_000)
    try:
        assert find_band(14_074_000) == shm_name(2)
        assert find_band(7_074_000) is None
    finally:
        w.close()


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------
def test_replay_source_npy(tmp_path):
    data = (np.arange(10_000) + 1j * np.arange(10_000)).astype(np.complex64)
    p = tmp_path / "iq.npy"
    np.save(p, data)
    src = ReplaySource(p, sample_rate=8_000, lo_freq=7_000_000, block_size=4_000)
    b1 = src.read_block()
    b2 = src.read_block()
    assert src.read_block() is None  # only 2000 left < block
    np.testing.assert_array_equal(np.concatenate([b1, b2]), data[:8_000])


def test_open_source_spec_params(tmp_path):
    data = np.zeros(100, np.complex64)
    p = tmp_path / "iq.npy"
    np.save(p, data)
    src = open_source(f"file:{p}?sr=48000&lo=14000000&block=50")
    assert src.sample_rate == 48_000 and src.lo_freq == 14_000_000
    assert src.block_size == 50
    with pytest.raises(ValueError):
        open_source("warp:nope")


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------
def test_scheduler_fires_boundaries():
    fired = []
    s = CadenceScheduler()
    s.subscribe(15.0, lambda b: fired.append(("ft8", b)))
    s.subscribe(7.5, lambda b: fired.append(("ft4", b)))
    s.run_once(now=112.5)
    assert fired == [("ft4", 112.5)]       # 112.5 is an FT4-only boundary
    fired.clear()
    s.run_once(now=120.0)                  # both cadences land on 120
    assert ("ft8", 120.0) in fired and ("ft4", 120.0) in fired
    fired.clear()
    s.run_once(now=121.0)                  # nothing new due
    assert fired == []
    s.run_once(now=135.1)                  # catches up 127.5 (ft4) + 135 (both)
    assert fired == [("ft8", 135.0), ("ft4", 127.5), ("ft4", 135.0)]


# ---------------------------------------------------------------------------
# Decoder pool
# ---------------------------------------------------------------------------
class _FakeDecoder:
    def __init__(self, mode):
        self.mode = mode

    def decode(self, audio):
        return [[DecodeResult("CQ W2AXR FN13", -10, 0.0, 1500.0, mode=self.mode)]
                for _ in range(audio.shape[0])]


def _job(mode, n_ch=2, epoch=None):
    return DecodeJob(
        mode=mode,
        audio=np.zeros((n_ch, 1000), np.float32),
        base_freqs=[14_074_000] * n_ch,
        decoder_indices=list(range(n_ch)),
        epoch_time=int(epoch if epoch is not None else time.time()),
    )


def test_pool_decodes_and_reports():
    got = []
    pool = DecoderPool(num_workers=2, max_long_workers=1,
                       on_result=lambda j, ci, r: got.append((j.mode, ci, r)),
                       decoder_factory=_FakeDecoder)
    pool.init()
    try:
        pool.push(_job(Mode.FT8, 3))
        pool.push(_job(Mode.WSPR, 2))   # long queue
        deadline = time.monotonic() + 5
        while len(got) < 5 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(got) == 5
        assert pool.count_decoded_windows == 5
    finally:
        pool.terminate()


def test_pool_drops_stale():
    pool = DecoderPool(num_workers=1, max_data_age_factor=10.0,
                       decoder_factory=_FakeDecoder)
    try:
        # a job that sat in the queue > maxdataage*T_R (150 s) is shed
        job = _job(Mode.FT8, 2)
        pool.push(job)
        job.enqueued_at = time.time() - 1200  # simulate 20 min backlog
        pool.init()  # start workers only after backdating
        deadline = time.monotonic() + 3
        while pool.count_dropped_stale < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert pool.count_dropped_stale == 2
        assert pool.count_decoded_windows == 0
    finally:
        pool.terminate()


# ---------------------------------------------------------------------------
# Receiver end-to-end: IQ stream -> channelizer -> framing -> decode
# ---------------------------------------------------------------------------
def test_receiver_end_to_end_ft8():
    fs = 48_000
    lo = 14_080_000
    dial = 14_074_000
    text = "CQ W2AXR FN13"
    # build 31 s of IQ: bursts in window 0 and window 1
    src = SyntheticSource(fs, lo, block_size=fs // 2, noise_amplitude=0.005,
                          seed=1)
    sps_iq = ft8.SPS * fs // ft8.WAVE_SR
    offset = dial + 1500.0 - lo          # audio 1500 Hz -> IQ offset
    burst = gfsk_modulate_iq(ft8.encode_message(text), offset, sps_iq, fs,
                             ft8.TONE_SPACING)
    src.inject(int(0.5 * fs), 0.3 * burst)
    src.inject(int(15.5 * fs), 0.3 * burst)

    spots = []
    pool = DecoderPool(
        num_workers=1,
        on_result=lambda j, ci, r: spots.append((j.epoch_time, ci, r.message)),
        decoder_factory=lambda mode: ft8.FT8Decoder(top_k=16, bp_iters=20),
    )
    pool.init()
    rx = Receiver(
        src,
        [DecoderLine(dial, Mode.FT8), DecoderLine(14_080_000, Mode.FT8)],
        pool,
        utc_anchor=1_699_999_995,
    )
    try:
        # feed 31 s of stream time directly (no thread; deterministic)
        for _ in range(62):
            rx.process_iq(src.read_block())
        # wait for both windows to finish decoding (drain only empties the
        # queue; the in-flight decode incl. first-compile takes seconds)
        deadline = time.monotonic() + 60
        while pool.count_decoded_windows < 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        msgs = {(e, ci, m) for e, ci, m in spots}
        assert (1_699_999_995, 0, text) in msgs      # window 0, channel 0
        assert (1_700_000_010, 0, text) in msgs      # window 1
        assert all(ci == 0 for _, ci, _ in spots)    # other channel quiet
    finally:
        pool.terminate()


def test_receiver_aligns_each_mode_to_its_own_period():
    """Long-mode windows start on their OWN period boundary, not the 15 s
    app anchor (a WSPR window anchored at XX:00:45 would miss every real
    transmission)."""
    src = SyntheticSource(48_000, 14_080_000, block_size=48_000 // 2)
    pool = DecoderPool(num_workers=1, decoder_factory=_FakeDecoder)
    rx = Receiver(
        src,
        [DecoderLine(14_074_000, Mode.FT8), DecoderLine(14_078_000, Mode.WSPR)],
        pool,
        utc_anchor=30.0,   # a 15 s boundary but NOT a 120 s boundary
    )
    assert rx._skip[Mode.FT8] == 0 and rx._epoch0[Mode.FT8] == 30.0
    assert rx._epoch0[Mode.WSPR] == 120.0
    assert rx._skip[Mode.WSPR] == 90 * 12_000


def test_receiver_thread_and_status(tmp_path):
    fs = 48_000
    data = np.zeros(fs * 2, np.complex64)
    p = tmp_path / "iq.npy"
    np.save(p, data)
    src = ReplaySource(p, fs, 14_080_000, block_size=fs // 4)
    pool = DecoderPool(num_workers=1, decoder_factory=_FakeDecoder)
    rx = Receiver(src, [DecoderLine(14_074_000, Mode.FT8)], pool)
    assert rx.get_status() == Status.NOT_INITIALIZED
    rx.init()
    deadline = time.monotonic() + 10
    while rx.get_status() != Status.FINISHED and time.monotonic() < deadline:
        time.sleep(0.05)
    assert rx.get_status() == Status.FINISHED   # stream ended
    rx.terminate()


def test_app_reaps_finished_live_receivers():
    """FINISHED receivers of LIVE sources are reaped so the re-attach
    cadence rebuilds them (reference re-setups FINISHED decoders every
    ~10 s, CWSL_DIGI.cpp:1217-1226); a FINISHED file replay is terminal."""
    from cwsl_digi_tpu.config import default_config
    from cwsl_digi_tpu.runtime.app import App

    class _Rx:
        def __init__(self, status):
            self._s = status
            self.terminated = False

        def get_status(self):
            return self._s

        def terminate(self):
            self.terminated = True

    app = App.__new__(App)
    app.receivers = {
        "shm:CWSL0Band": _Rx(Status.FINISHED),
        "tcp:1.2.3.4:5000": _Rx(Status.STOPPED),
        "file:/tmp/x.npy": _Rx(Status.FINISHED),
        "synthetic:": _Rx(Status.RUNNING),
    }

    class _P:
        def warn(self, *_a, **_k):
            pass

    app.printer = _P()
    app._reap_dead_receivers()
    assert set(app.receivers) == {"file:/tmp/x.npy", "synthetic:"}


def test_highestdecodefreq_bounds_decode_band(tmp_path):
    """wsjtx.highestdecodefreq flows into every jt9-analog decoder's
    fmax_hz (jt9 -H semantics, source/DecoderPool.hpp:636-651); FST4W
    keeps its fixed 1400-1600 Hz band (-L 1400 -H 1600, :655-658)."""
    from cwsl_digi_tpu.config import load_config
    from cwsl_digi_tpu.constants import Mode
    from cwsl_digi_tpu.runtime.app import App

    ini = tmp_path / "hdf.ini"
    ini.write_text("""
[radio]
source=synthetic:?sr=48000&lo=14077000
[operator]
callsign=W2AXR
gridsquare=FN13
[decoders]
decoder=14074000 FT8
[wsjtx]
highestdecodefreq=2000
[logging]
loglevel=1
""")
    app = App(load_config(ini), max_runtime_s=1)
    factory = app.pool._decoder_factory
    for mode in (Mode.FT8, Mode.FT4, Mode.JS8, Mode.JT65, Mode.Q65_30,
                 Mode.FST4_60):
        dec = factory(mode)
        assert dec.spec.fmax_hz == 2000.0, mode
    assert factory(Mode.FST4W_120).spec.fmax_hz == 1600.0


def test_reanchor_tracks_utc_under_clock_error():
    """±50 ppm SDR clock error over a simulated hour: window boundaries
    stay within ±0.1 s of nominal UTC (the reference re-syncs every window
    via wall-clock buffer swaps, source/Instance.cpp:203-221)."""
    from cwsl_digi_tpu.sdr.source import SyntheticSource

    fs, lo = 48_000, 14_077_000
    trp = 15.0
    cap = int(trp * 12_000)

    for ppm in (50e-6, -50e-6):
        src = SyntheticSource(fs, lo, block_size=fs // 4)
        src.live = True     # re-anchoring applies to live sources only

        class _P:
            def __init__(self):
                self.jobs = []

            def push(self, job):
                self.jobs.append(job)

        pool = _P()
        rx = Receiver(src, [DecoderLine(14_074_000, Mode.FT8)], pool,
                      utc_anchor=0.0)

        # simulate: the SDR delivers audio at 12000*(1+ppm) samples per
        # true wall second; stamp ingest wall accordingly
        state = {"audio_in": 0}

        def stamp():
            if state["audio_in"] == 0:
                return None
            wall = state["audio_in"] / (12_000.0 * (1.0 + ppm))
            return state["audio_in"] * rx._dec_ratio, wall

        rx._ingest_stamp = stamp

        mis = []
        orig = rx._reanchor_samples

        def spy(mode, end_pos):
            iq_in, wall = rx._ingest_stamp()
            audio_in = iq_in / rx._dec_ratio
            wall_at_end = wall - (audio_in - end_pos) / 12_000.0
            nominal_end = rx._epoch0[mode] + rx._window_index[mode] * trp
            mis.append(wall_at_end - nominal_end)
            return orig(mode, end_pos)

        rx._reanchor_samples = spy

        chunk = np.zeros((1, 12_000), np.float32)   # 1 stream-second
        for _ in range(3600):
            state["audio_in"] += chunk.shape[1]
            rx._accumulate(chunk)

        assert len(pool.jobs) > 200
        # drift never exceeds the ±0.1 s bound at any boundary
        assert max(abs(m) for m in mis) < 0.1, (ppm, max(mis), min(mis))
        # and it is actively corrected, not just slow: uncorrected drift
        # at hour end would be 3600*50e-6 = 0.18 s
        assert abs(mis[-1]) < 0.05, (ppm, mis[-1])


def test_ingest_ring_decouples_slow_channelizer():
    """A stalled channelize step must not lose source blocks: the ingest
    thread keeps draining the source into the ~3 s ring (backpressure,
    reference Receiver.hpp:222-229), and every sample still comes out in
    order once the stall clears (round-2 finding: device call on the
    ingest thread let the shm ring get lapped silently)."""
    import time as _time

    from cwsl_digi_tpu.runtime import receiver as rxmod

    fs = 48_000
    n_blocks = 24
    blk = fs // 8    # 0.125 s per block -> 3 s of data

    class _SeqSource:
        sample_rate = fs
        lo_freq = 14_077_000
        block_size = blk
        live = False
        overruns = 0

        def __init__(self):
            self.emitted = 0

        def read_block(self, timeout=1.0):
            if self.emitted >= n_blocks:
                return None
            v = np.arange(self.emitted * blk, (self.emitted + 1) * blk,
                          dtype=np.float32)
            self.emitted += 1
            return (v + 0j).astype(np.complex64)

    class _P:
        def __init__(self):
            self.jobs = []

        def push(self, job):
            self.jobs.append(job)

    rx = Receiver(_SeqSource(), [DecoderLine(14_074_000, Mode.FT8)], _P(),
                  utc_anchor=0.0)
    seen = []
    orig_process = rx.process_iq

    def slow_process(block):
        seen.append(np.asarray(block).real.copy())
        _time.sleep(0.05)   # a slow device dispatch

    rx.process_iq = slow_process
    rx.init()
    deadline = _time.monotonic() + 15
    while rx.status == rxmod.Status.RUNNING and _time.monotonic() < deadline:
        _time.sleep(0.05)
    rx.terminate()

    got = np.concatenate(seen) if seen else np.zeros(0)
    assert len(got) == n_blocks * blk, (len(got), n_blocks * blk)
    # in order, nothing lost
    np.testing.assert_array_equal(got, np.arange(n_blocks * blk,
                                                 dtype=np.float32))
    assert rx.overruns == 0


def test_shm_overruns_are_counted(tmp_path):
    """When a live shm writer laps a stalled reader, the skipped blocks
    surface as ShmSource.overruns instead of a silent index jump."""
    from cwsl_digi_tpu.sdr.shm import ShmSource, ShmWriter

    name = f"test_ovr_{np.random.randint(1 << 30)}"
    w = ShmWriter(name, sample_rate=48_000, block_in_samples=1024,
                  l0=14_000_000, num_blocks=4)
    try:
        src = ShmSource(name)
        blk = np.zeros(1024, np.complex64)
        w.write_block(blk)
        assert src.read_block(timeout=0.2) is not None
        for _ in range(9):     # lap the 4-block ring twice over
            w.write_block(blk)
        assert src.read_block(timeout=0.2) is not None
        assert src.overruns == 6   # 9 written, ring holds 3 readable
        src.close()
    finally:
        w.close(unlink=True)
