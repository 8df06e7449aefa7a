"""Benchmark: wideband IQ→audio throughput on one NVIDIA GPU — self-validating.

Runs the flagship pipeline — polyphase channelizer splitting a 30.72 MHz
capture into 2560 channels, each through the full receiver chain
(passband FIR → AM demod → AGC → 4× polyphase resample) — and reports
aggregate input Msamples/s on the card, for BOTH tuning profiles.

Methodology:
  * Fails unless JAX computes on a GPU; prints the platform, device kind
    and count, and the card's name and power limit (nvidia-smi) first.
  * Integrity gates BEFORE timing, against CPU-backend subprocess
    oracles running the plain (FFT passband, XLA tail, f32)
    implementation (the child sets JAX_PLATFORMS=cpu before importing
    jax, so it never touches the card):
      - SMALL (16 chans): full audio readback, ≥50 dB SNR required.
      - MID (2560 chans, short chunk): the headline's channel count, so
        a width-dependent numerical bug in the big shapes fails the gate.
      - MID-SSB (2560 chans, mode USB) and MID-NBFM (2560 chans, NBFM;
        Carson-safe FM carriers, AGC manual — see _gate_nbfm): the other
        demodulators at the headline channel count.
    Oracle outputs are profile-independent (the oracle runs the plain
    path), so refs are computed once and shared across profiles.
  * Consistency check: the timed run's AGC-transient-aligned audio
    prefix must match the oracle-validated MID run's level within 25 %.
  * The timed input is generated on the device (jax.random); timing
    waits on the device (block_until_ready) and on a fetched reduction
    of the final audio.
  * The int16 ingest path must match the dequantized-f32 run at ≥80 dB
    before it is timed. Any failing phase fails the run.

Baseline: the reference client processes one 12 kHz receiver in real time
(SURVEY.md §6); the repo's north-star target is 1 Gsample/s aggregate
over ≥2 hosts, i.e. 500 Msamples/s per host; `vs_baseline` = fast-profile
Msps / 500.

Prints ONE JSON line: the fast profile as the headline {"metric",
"value", ...} plus a "quality" sub-object with the quality tier's own
timing and gates.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
GATE_DB = 50.0           # oracle agreement each gate requires
I16_GATE_DB = 80.0       # i16 ingest vs the dequantized-f32 run


def _profiles():
    # single source of truth: supersdr_jax.runtime.wideband.PROFILES
    sys.path.insert(0, _REPO)
    from supersdr_jax.runtime.wideband import PROFILES
    return PROFILES


PROFILE = os.environ.get("BENCH_PROFILE", "fast")
PROFILES = _profiles()

SMALL = dict(fs_in=192_000, n_chan=16, chunk_in=32_768, mode="AM",
             taps_per=8, n_taps=257, audio_rate=48_000)
# MID: the headline's n_chan at a chunk small enough for the CPU oracle
MID = dict(fs_in=30_720_000, n_chan=2560, chunk_in=2560 * 512, mode="AM",
           taps_per=8, n_taps=257, audio_rate=48_000)
MID_SSB = dict(fs_in=30_720_000, n_chan=2560, chunk_in=2560 * 512,
               mode="USB", taps_per=8, n_taps=257, audio_rate=48_000)
MID_NBFM = dict(fs_in=30_720_000, n_chan=2560, chunk_in=2560 * 512,
                mode="NBFM", taps_per=8, n_taps=257, audio_rate=48_000)
HEADLINE = dict(fs_in=30_720_000, n_chan=2560,
                chunk_in=2560 * (16384 - 256), mode="AM",
                taps_per=8, n_taps=257, audio_rate=48_000)
# N_SCAN chunks per dispatch via tuple-output multi-chunk programs
# (wideband.process_n — no [N,...] audio stack); N_SCAN=1 steps through
# single-chunk process().
N_SCAN = int(os.environ.get("BENCH_N_SCAN", "2"))
MIN_MEASURE_S = 2.0

_ORACLE_SRC = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax
sys.path.insert(0, {repo!r})
from supersdr_jax.runtime import wideband
d = np.load(sys.argv[1])
cfg = wideband.WidebandConfig(**{cfg!r})
params = wideband.make_params(cfg)
state = wideband.init_state(cfg)
_, audio = wideband.process_many(cfg, params, state, d["iq"])
np.savez(sys.argv[2], audio=np.asarray(audio))
"""

_oracle_refs = {}    # tag -> (iq, ref audio) — shared across profiles


def _snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    num = float(np.linalg.norm(ref))
    den = float(np.linalg.norm(got - ref))
    if den == 0.0:
        return np.inf
    return 20.0 * np.log10(max(num, 1e-30) / den)


def _run_oracle(src: str, iq: np.ndarray) -> np.ndarray:
    """Run an oracle program in a CPU-only child process on `iq`."""
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "in.npz")
        outp = os.path.join(tmp, "out.npz")
        np.savez(inp, iq=iq)
        subprocess.run([sys.executable, "-c", src, inp, outp], check=True,
                       timeout=1800)
        return np.load(outp)["audio"]


def _oracle(base_cfg: dict, n_chunks: int, seed: int, tag: str):
    if tag in _oracle_refs:
        return _oracle_refs[tag]
    rng = np.random.default_rng(seed)
    iq = ((rng.normal(size=(n_chunks, base_cfg["chunk_in"]))
           + 1j * rng.normal(size=(n_chunks, base_cfg["chunk_in"]))) * 0.05
          ).astype(np.complex64)
    ref = _run_oracle(_ORACLE_SRC.format(repo=_REPO, cfg=base_cfg), iq)
    _oracle_refs[tag] = (iq, ref)
    return iq, ref


def _gate(tuning: dict, base_cfg: dict, n_chunks: int, seed: int,
          tag: str) -> dict:
    """Run `base_cfg`+tuning on this backend vs the plain-path CPU
    oracle; require finite, nonzero, ≥50 dB agreement."""
    from supersdr_jax.runtime import wideband

    iq, ref = _oracle(base_cfg, n_chunks, seed, tag)
    cfg = wideband.WidebandConfig(**base_cfg, **tuning)
    params = wideband.make_params(cfg)
    state = wideband.init_state(cfg)
    _, audio = wideband.process_many(cfg, params, state, iq)
    got = np.asarray(audio)          # full fetch — fails loudly if aborted
    if tuning.get("time_major"):
        got = np.swapaxes(got, -1, -2)
    got = got.astype(np.float32)
    snr = _snr_db(ref, got)
    ok = bool(np.isfinite(got).all()) and float(np.abs(got).mean()) > 0 \
        and snr >= GATE_DB
    return {f"oracle_snr_db_{tag}": round(float(snr), 1),
            f"audio_mean_abs_{tag}": round(float(np.abs(got).mean()), 6),
            f"ok_{tag}": ok}


_ORACLE_NBFM_SRC = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax
sys.path.insert(0, {repo!r})
from supersdr_jax.runtime import wideband
d = np.load(sys.argv[1])
cfg = wideband.WidebandConfig(**{cfg!r})
params = wideband.make_params(cfg, agc_kwargs=dict(on=False))
state = wideband.init_state(cfg)
_, audio = wideband.process_many(cfg, params, state, d["iq"])
np.savez(sys.argv[2], audio=np.asarray(audio))
"""


def _nbfm_input(seed: int):
    """FM carriers at 16 channel centers (Carson-safe deviation — the
    discriminator wraps at +/-fs_chan/2) over a -52 dB noise floor.
    An all-noise input would gate CONDITIONING, not kernels: the angle
    of a near-zero sample is ill-defined and diverges across correct
    implementations."""
    C, n = MID_NBFM["n_chan"], MID_NBFM["chunk_in"]
    fs = MID_NBFM["fs_in"]
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    z = 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    kbins = rng.choice(C, size=16, replace=False)
    for k in kbins:
        fk = (k if k < C // 2 else k - C) * (fs / C)
        g = rng.uniform(300.0, 1000.0)
        beta = rng.uniform(1.0, 2.5)
        z = z + 0.4 * np.exp(1j * (2 * np.pi * fk * t
                                   + beta * np.sin(2 * np.pi * g * t)))
    return z.astype(np.complex64)[None, :], kbins


def _gate_nbfm(tuning: dict, seed: int = 6) -> dict:
    """NBFM at the headline channel count vs the plain-path CPU oracle.
    AGC runs MANUAL: with AGC on, both pipelines
    amplify the (ill-conditioned, implementation-divergent) FIR-rampup
    angle garbage into the tracked peak, and the 4 s decay carries that
    divergence through the whole window — the gate would measure the
    transient, not the kernels. Compared on the carrier-bearing rows
    past the FIR+attack transient."""
    from supersdr_jax.runtime import wideband

    tag = "midnbfm"
    if tag in _oracle_refs:
        iq, kbins, ref = _oracle_refs[tag]
    else:
        iq, kbins = _nbfm_input(seed)
        ref = _run_oracle(_ORACLE_NBFM_SRC.format(repo=_REPO, cfg=MID_NBFM),
                          iq)
        _oracle_refs[tag] = (iq, kbins, ref)
    cfg = wideband.WidebandConfig(**MID_NBFM, **tuning)
    params = wideband.make_params(cfg, agc_kwargs=dict(on=False))
    state = wideband.init_state(cfg)
    _, audio = wideband.process_many(cfg, params, state, iq)
    got = np.asarray(audio).astype(np.float32)
    if tuning.get("time_major"):
        got = np.swapaxes(got, -1, -2)
    S = 1280                       # skip the FIR + attack transient
    rg, gg = ref[:, kbins, S:], got[:, kbins, S:]
    snr = _snr_db(rg, gg)
    ok = bool(np.isfinite(gg).all()) and float(np.abs(gg).mean()) > 0 \
        and snr >= GATE_DB
    return {"oracle_snr_db_midnbfm": round(float(snr), 1),
            "audio_mean_abs_midnbfm": round(float(np.abs(gg).mean()), 6),
            "ok_midnbfm": ok}


def integrity_check(tuning: dict) -> dict:
    small = _gate(tuning, SMALL, n_chunks=2, seed=0, tag="small")
    mid = _gate(tuning, MID, n_chunks=1, seed=2, tag="mid")
    ssb = _gate(tuning, MID_SSB, n_chunks=1, seed=4, tag="midssb")
    nbfm = _gate_nbfm(tuning)
    ok = small.pop("ok_small") and mid.pop("ok_mid") \
        and ssb.pop("ok_midssb") and nbfm.pop("ok_midnbfm")
    return {"integrity": "pass" if ok else "fail", **small, **mid, **ssb,
            **nbfm}


def card() -> str:
    """The card's name and power limit, from nvidia-smi (a child process
    that never opens JAX)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def device_info() -> dict:
    """The device as JAX reports it; raises unless it is a GPU."""
    import jax

    from supersdr_jax import backend

    if backend.route() != backend.GPU:
        raise RuntimeError("the benchmark measures an NVIDIA GPU; JAX "
                           f"found {jax.default_backend()!r}")
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def measure(tuning: dict) -> dict:
    """Gates + headline timing for one tuning profile."""
    import jax
    import jax.numpy as jnp

    from supersdr_jax.ops import cx
    from supersdr_jax.runtime import wideband

    checks = integrity_check(tuning)
    if checks["integrity"] != "pass":
        return {"value": 0.0, **checks}

    cfg = wideband.WidebandConfig(**HEADLINE, **tuning)
    params = wideband.make_params(cfg)
    state = wideband.init_state(cfg)

    @jax.jit
    def gen(key):
        kr, ki = jax.random.split(key)
        shp = (N_SCAN, cfg.chunk_in)
        return cx.CX(0.05 * jax.random.normal(kr, shp, jnp.float32),
                     0.05 * jax.random.normal(ki, shp, jnp.float32))

    iq_dev = gen(jax.random.PRNGKey(1))

    def fetch_stat(audio):
        # device-side reduction over the WHOLE audio tensor, fetched
        return float(jnp.mean(jnp.abs(audio.astype(jnp.float32))))

    iq_single = cx.CX(iq_dev.re[0], iq_dev.im[0])   # sliced ONCE
    if N_SCAN == 1:
        def step(st_):
            st2, out = wideband.process(cfg, params, st_, iq_single)
            return st2, out.audio
    else:
        iq_tup = (iq_single,) * N_SCAN

        def step(st_):
            st2, outs = wideband.process_n(cfg, params, st_, iq_tup)
            return st2, outs[-1]

    t0 = time.perf_counter()
    st, audio = step(state)
    stat0 = fetch_stat(audio)
    compile_s = time.perf_counter() - t0
    if not (np.isfinite(stat0) and stat0 > 0):
        raise RuntimeError(f"warmup audio bad: {stat0}")

    samples_per_step = N_SCAN * cfg.chunk_in
    iters = 8
    while True:
        t0 = time.perf_counter()
        st_t = st
        for _ in range(iters):
            st_t, audio = step(st_t)
        jax.block_until_ready(audio)
        stat = fetch_stat(audio)
        dt = time.perf_counter() - t0
        if dt >= MIN_MEASURE_S or iters >= 256:
            break
        iters *= 2

    if not (np.isfinite(stat) and stat > 0):
        raise RuntimeError(f"timed audio bad: {stat}")
    prefix = headline_prefix_level(cfg, params, state, iq_dev)
    mid_level = checks["audio_mean_abs_mid"]
    if abs(prefix - mid_level) > 0.25 * mid_level:
        return {"value": 0.0, **checks, "integrity": "fail",
                "audio_mean_abs_headline_prefix": prefix,
                "consistency": "headline prefix level diverges from "
                               "oracle-checked mid config"}

    msps = samples_per_step * iters / dt / 1e6
    out = {
        "value": msps,
        "step_ms": dt / iters * 1e3,
        "compile_s": compile_s,
        "elapsed_s": dt,
        "iters": iters,
        "audio_mean_abs_headline": stat,
        "audio_mean_abs_headline_prefix": prefix,
        **checks,
    }
    # INT16 ingest (the 16-bit ADC / KiwiSDR IQ wire format —
    # /root/reference/kiwi/client.py:443-454 carries IQ as s16): the
    # dequantize fuses into the channelizer's first pass. Validated on
    # the device against the dequantized-f32 pipeline before timing.
    i16_snr = i16_vs_f32_snr_db(cfg, params, state)
    if i16_snr < I16_GATE_DB:
        raise RuntimeError(f"i16 path diverges: {i16_snr:.1f} dB")
    iq16 = gen_i16(cfg.chunk_in)
    it16 = max(iters // 2, 8)
    iq16_tup = (iq16,) * N_SCAN
    s16, o16s = wideband.process_n(cfg, params, state, iq16_tup)
    fetch_stat(o16s[-1])
    t0 = time.perf_counter()
    for _ in range(it16):
        s16, o16s = wideband.process_n(cfg, params, s16, iq16_tup)
    jax.block_until_ready(o16s)
    stat16 = fetch_stat(o16s[-1])
    dt16 = time.perf_counter() - t0
    if not (np.isfinite(stat16) and stat16 > 0):
        raise RuntimeError(f"i16 audio bad: {stat16}")
    out["i16_ingest"] = {
        "value": N_SCAN * cfg.chunk_in * it16 / dt16 / 1e6,
        "step_ms": dt16 / it16 / N_SCAN * 1e3,
        "vs_f32_snr_db": i16_snr}
    return out


def gen_i16(n: int, seed: int = 1):
    """(re_i16, im_i16) [n] device planes of Gaussian IQ at 0.05 rms."""
    import jax
    import jax.numpy as jnp

    kr, ki = jax.random.split(jax.random.PRNGKey(seed))
    return tuple((0.05 * jax.random.normal(k, (n,), jnp.float32)
                  * 32768.0).astype(jnp.int16) for k in (kr, ki))


def i16_vs_f32_snr_db(cfg, params, state) -> float:
    """SNR (dB) of the int16-ingest audio against the pipeline fed the
    dequantized f32 planes, one chunk on the device."""
    import jax.numpy as jnp

    from supersdr_jax.ops import cx
    from supersdr_jax.runtime import wideband

    iq16 = gen_i16(cfg.chunk_in)
    deq = cx.CX(iq16[0].astype(jnp.float32) / 32768.0,
                iq16[1].astype(jnp.float32) / 32768.0)
    _, o16 = wideband.process_i16(cfg, params, state, iq16)
    _, of = wideband.process(cfg, params, state, deq)
    a16 = o16.audio.astype(jnp.float32)
    af = of.audio.astype(jnp.float32)
    num = float(jnp.linalg.norm(af))
    den = float(jnp.linalg.norm(a16 - af))
    return 20.0 * np.log10(max(num, 1e-30) / max(den, 1e-30))


def headline_prefix_level(cfg, params, state, iq_dev) -> float:
    """Mean |audio| of the headline's first 512 samples per channel (at
    the IQ rate) from a fresh state. The MID gate ran the same n_chan and
    input distribution for 512 samples per channel, so this prefix
    (identical ensemble, identical AGC-transient position) must match
    its level; whole-run means are not comparable across chunk lengths,
    where the AGC attack transient dominates them."""
    import jax.numpy as jnp

    from supersdr_jax.runtime import wideband

    _, audio0 = wideband.process_many(cfg, params, state, iq_dev)
    L = cfg.chain_cfg.upsample
    head = (audio0[0, : 512 * L, :] if cfg.time_major
            else audio0[0, :, : 512 * L])
    return float(jnp.mean(jnp.abs(head.astype(jnp.float32))))


def main():
    from supersdr_jax import backend

    backend.enable_compile_cache()
    name = card()
    dev = device_info()
    print(f"card: {name}; device: {dev}", flush=True)
    res = measure(PROFILES[PROFILE])
    out = {
        "metric": "wideband_iq_to_audio_throughput",
        "unit": "Msamples/s/chip",
        "vs_baseline": res["value"] / 500.0,
        "baseline_definition": "north-star 1 Gsps aggregate / 2 hosts = "
                               "500 Msps per-host share",
        "profile": PROFILE,
        "card": name,
        "device": dev,
        "config": {"n_chan": HEADLINE["n_chan"], "fs_in": HEADLINE["fs_in"],
                   "chunk_in": HEADLINE["chunk_in"], "n_scan": N_SCAN,
                   **PROFILES[PROFILE]},
        **res,
    }
    other = "quality" if PROFILE == "fast" else "fast"
    ores = measure(PROFILES[other])
    out[other] = {"unit": "Msamples/s/chip",
                  "config": dict(PROFILES[other]), **ores}
    print(json.dumps(out))
    if (out["integrity"] != "pass" or out["value"] <= 0
            or ores["integrity"] != "pass" or ores["value"] <= 0):
        sys.exit(1)


if __name__ == "__main__":
    main()
