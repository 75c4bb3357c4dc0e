"""CWSL_DIGI_TPU — a multi-channel weak-signal digital-mode skimmer in JAX.

A from-scratch re-design of the capabilities of alexranaldi/CWSL_DIGI
(reference: /root/reference, a Windows C++17 app that channelizes wideband SDR
IQ into per-frequency 12 kHz audio and decodes FT8/FT4/WSPR/JT65/Q65/FST4/
FST4W/JS8 via external WSJT-X/JS8Call processes, then reports spots to
PSK Reporter / WSPRNet / RBN Aggregator).

This framework inverts the reference's thread-per-channel architecture into
batched JAX/XLA programs:

- ``sdr/``      — IQ intake (file replay, socket, POSIX shm mirroring the
                  reference's CWSL shared-memory contract).
- ``dsp/``      — the batched channelizer: NCO mix + windowed-sinc FIR
                  decimation for hundreds of channels in one device program
                  (reference: source/SSBD.hpp, source/LowPass.hpp).
- ``modes/``    — native decoders as JAX programs (FT8, FT4, WSPR, ...);
                  the reference delegates these to jt9.exe/wsprd.exe/js8.exe.
- ``runtime/``  — UTC cadence scheduler, decode batching pool, supervision
                  (reference: source/CWSL_DIGI.cpp sync threads,
                  source/DecoderPool.hpp).
- ``report/``   — spot grammar + PSK Reporter / WSPRNet / RBN clients
                  (reference: source/OutputHandler.cpp, PSKReporter.cpp,
                  WSPRNet.cpp, RBNHandler.hpp).
- ``parallel/`` — jax.sharding meshes, channel/time sharding, halo exchange.
"""

from cwsl_digi_tpu.version import __version__, PROGRAM_NAME

__all__ = ["__version__", "PROGRAM_NAME"]
