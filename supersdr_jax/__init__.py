"""supersdr_jax — a software-defined-radio framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
mcogoni/supersdr (a KiwiSDR client): streaming FFT spectrum + waterfall with
LINRAD-style averaging and percentile auto-leveling, adjustable FIR/polyphase
bandpass filtering, AGC, AM/SSB/CW/NBFM demodulation, resampling — with the
DSP that the reference delegates to the KiwiSDR server implemented natively
as batched device programs (XLA, plus Pallas GPU kernels where they
win), scaled over multi-GPU meshes by sharding receiver channels and time
blocks.

Layers (bottom-up):
  ops/      pure-function DSP kernel library (JAX; a Pallas GPU kernel
            for the chain's recurrent tail)
  runtime/  streaming block engine: receiver chains, blockers, governor
  parallel/ mesh sharding: channel/time axes, halo exchange collectives
  io/       host-side sources & sinks: WAV, KiwiSDR protocol, rigctl, audio
  control/  control plane: receivers, panadapter math, band plan, databases
"""

from supersdr_jax.version import __version__

__all__ = ["__version__"]
