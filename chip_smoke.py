"""Smoke run of the wideband receiver on an NVIDIA GPU, end to end.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the mesh path only

Phases (one process holds the card; children never open it):
  1. the card (nvidia-smi) and the devices JAX sees — fails unless GPU
  2. compile of the headline step for both profiles: seconds, memory
  3. correctness on the card: the four oracle gates of bench.py per
     profile (≥ 50 dB against the plain path run on the CPU in a child),
     int16 ingest against the dequantized f32 run (≥ 80 dB), and the
     Triton chain tail against the XLA tail at 2560 channels per mode
  4. the headline deployment (30.72 MHz, 2560 channels, 41.3 Msample
     chunks) for a few chunks through wideband.process_n
  5. the CLI in-process on synthetic WAVs: wideband, demod, waterfall,
     and kiwi against a loopback fake KiwiSDR
  6. the tests marked `gpu` (run in a child before this process opens
     the card)
--four: the mesh pipeline (parallel/sharded_wideband) at the headline
over four cards, against the one-card serial output, rows in bin order.

Any failing phase raises and the script exits non-zero. The last line is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TAIL_TOL = 1e-4          # kernel vs XLA tail: max |diff| / max |ref|
MESH_GATE_DB = 50.0      # mesh vs serial audio SNR
PREFIX_TOL = 0.25        # headline prefix level vs the MID gate's


class SmokeError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)


def card_lines() -> str:
    """nvidia-smi's name and power limit of each card (a child process
    that never opens JAX). Raises where there is no NVIDIA driver."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def run_gpu_tests() -> tuple[int, str]:
    """The tests marked `gpu`, in a child that holds the card alone."""
    env = dict(os.environ, SUPERSDR_GPU_TESTS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", os.path.join(REPO, "tests")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    return proc.returncode, (proc.stdout + proc.stderr).strip()


def device_info(expect_count: int | None = None) -> dict:
    import jax

    devs = jax.devices()
    print("jax.devices():", devs, flush=True)
    check(devs[0].platform == "gpu",
          f"JAX found {devs[0].platform!r}, not a GPU")
    if expect_count is not None:
        check(len(devs) >= expect_count,
              f"need {expect_count} GPUs, JAX sees {len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs) if expect_count is None else expect_count}


def device_iq(n: int, seed: int):
    """[n] split-complex Gaussian IQ at 0.05 rms, made on the device."""
    import jax
    import jax.numpy as jnp

    from supersdr_jax.ops import cx

    kr, ki = jax.random.split(jax.random.PRNGKey(seed))
    return cx.CX(0.05 * jax.random.normal(kr, (n,), jnp.float32),
                 0.05 * jax.random.normal(ki, (n,), jnp.float32))


def compile_phase(base: dict, profiles: dict, n_scan: int = 2) -> None:
    """Compile the n_scan-chunk step per profile; print seconds and the
    compiled program's memory analysis."""
    import jax
    import jax.numpy as jnp

    from supersdr_jax.ops import cx
    from supersdr_jax.runtime import wideband

    for name, tuning in profiles.items():
        cfg = wideband.WidebandConfig(**base, **tuning)
        params = wideband.make_params(cfg)
        state = wideband.init_state(cfg)
        sds = jax.ShapeDtypeStruct((cfg.chunk_in,), jnp.float32)
        iqs = tuple(cx.CX(sds, sds) for _ in range(n_scan))
        t0 = time.perf_counter()
        compiled = jax.jit(wideband.process_n_traced, static_argnums=0
                           ).lower(cfg, params, state, iqs).compile()
        dt = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        print(f"compile {name}: {dt:.2f} s; memory: "
              f"arguments {mem.argument_size_in_bytes} B, "
              f"outputs {mem.output_size_in_bytes} B, "
              f"temp {mem.temp_size_in_bytes} B, "
              f"code {mem.generated_code_size_in_bytes} B", flush=True)


def gate_phase(profiles: dict) -> dict:
    """bench.py's oracle gates per profile; returns each profile's
    checks (the MID level feeds the headline's consistency rule)."""
    import bench

    out = {}
    for name, tuning in profiles.items():
        checks = bench.integrity_check(tuning)
        prec = ", ".join(f"{k}={v}" for k, v in tuning.items()
                         if k.endswith("precision"))
        for tag in ("small", "mid", "midssb", "midnbfm"):
            print(f"gate {name}/{tag}: "
                  f"{checks[f'oracle_snr_db_{tag}']} dB against the CPU "
                  f"plain path (tolerance ≥ {bench.GATE_DB} dB; {prec}; "
                  f"chain tail: kernel in f32)", flush=True)
        check(checks["integrity"] == "pass", f"gates failed: {checks}")
        out[name] = checks
    return out


def i16_phase(base: dict, tuning: dict) -> None:
    import bench
    from supersdr_jax.runtime import wideband

    cfg = wideband.WidebandConfig(**base, **tuning)
    snr = bench.i16_vs_f32_snr_db(cfg, wideband.make_params(cfg),
                                  wideband.init_state(cfg))
    print(f"i16 ingest vs dequantized f32 on the card: {snr:.2f} dB "
          f"(tolerance ≥ {bench.I16_GATE_DB} dB)", flush=True)
    check(snr >= bench.I16_GATE_DB, f"i16 ingest diverges: {snr:.2f} dB")


def tail_phase(C: int = 2560, n: int = 1024, *,
               interpret: bool = False) -> None:
    """The Triton chain tail against the XLA tail on the same passband
    input, per mode, with AGC hang and squelch on; two chained chunks
    (the chunk is shorter than the hang window, where the kernel's hang
    is exact)."""
    import jax
    import jax.numpy as jnp

    from supersdr_jax.runtime import chain

    kr, ki, kl = jax.random.split(jax.random.PRNGKey(3), 3)
    level = jnp.exp(jax.random.normal(kl, (C, 1)) * 2.0) * 0.1
    y = jax.lax.complex(jax.random.normal(kr, (C, n)),
                        jax.random.normal(ki, (C, n))) * level
    rssi = jax.random.normal(kl, (C, 1)) * 20.0 - 60.0
    for mode in ("AM", "USB", "CW", "NBFM"):
        cfg = chain.ChainConfig(mode=mode, iq_rate=12000, audio_rate=48000,
                                chunk=n, os_block=n, n_taps=257,
                                nco_enabled=False, hang_enabled=True,
                                squelch_enabled=True)
        params = chain.make_params(
            cfg, freq_offset_hz=np.zeros(C), agc_kwargs=dict(hang=True),
            squelch_kwargs=dict(enabled=True, thresh_db=-60.0))
        outs = []
        for tail in (chain.tail_xla,
                     lambda *a: chain.tail_kernel(*a, interpret=interpret)):
            f = jax.jit(tail, static_argnums=0)
            st = chain.init_state(cfg, (C,))
            audio = []
            for _ in range(2):
                d, a, sq, ic, au = f(cfg, params, st, y, rssi)
                st = st._replace(demod=d, agc=a, squelch=sq, interp_carry=ic)
                audio.append(np.asarray(au))
            outs.append(np.concatenate(audio, axis=-1))
        ref, got = outs
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max()) / max(scale, 1e-30)
        print(f"tail {mode} (hang, squelch on), {C} channels: kernel vs "
              f"XLA max |diff|/max|ref| = {err:.3e} (tolerance "
              f"{TAIL_TOL:.0e}; f32 on both sides)", flush=True)
        check(np.isfinite(got).all() and scale > 0 and err <= TAIL_TOL,
              f"kernel tail diverges from the XLA tail in {mode}")


def headline_phase(base: dict, tuning: dict, mid_level: float, card: str,
                   n_calls: int = 3, n_scan: int = 2) -> None:
    """The deployment for n_calls × n_scan chunks through process_n:
    audio finite and non-zero, prefix level consistent with MID."""
    import jax

    import bench
    from supersdr_jax.runtime import wideband

    cfg = wideband.WidebandConfig(**base, **tuning)
    params = wideband.make_params(cfg)
    state = wideband.init_state(cfg)
    iq = device_iq(cfg.chunk_in, seed=1)
    iqs = (iq,) * n_scan
    st, outs = wideband.process_n(cfg, params, state, iqs)   # compile
    jax.block_until_ready(outs)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        st, outs = wideband.process_n(cfg, params, st, iqs)
    jax.block_until_ready(outs)
    step_ms = (time.perf_counter() - t0) / (n_calls * n_scan) * 1e3
    audio = np.asarray(outs[-1], np.float32)
    level = float(np.abs(audio).mean())
    check(audio.shape == (cfg.chunk_per_chan * cfg.chain_cfg.upsample,
                          cfg.n_chan), f"audio shape {audio.shape}")
    check(bool(np.isfinite(audio).all()) and level > 0,
          "headline audio not finite and non-zero")
    iq_b = jax.tree.map(lambda a: a[None], iq)
    prefix = bench.headline_prefix_level(cfg, params, state, iq_b)
    print(f"headline: {n_calls * n_scan} chunks of {cfg.chunk_in} samples, "
          f"{cfg.n_chan} channels: audio {audio.shape} finite, mean |a| "
          f"{level:.6f}; prefix level {prefix:.6f} vs MID {mid_level:.6f} "
          f"(tolerance {PREFIX_TOL:.0%})", flush=True)
    check(abs(prefix - mid_level) <= PREFIX_TOL * mid_level,
          "headline prefix level diverges from the MID gate's")
    print(f"headline step (informative): {step_ms:.3f} ms per chunk on "
          f"{card}", flush=True)


def _tone_peak_hz(audio: np.ndarray, rate: int) -> float:
    a = audio[len(audio) // 2:].astype(np.float64)
    sp = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(len(a))))
    return float(np.fft.rfftfreq(len(a), 1.0 / rate)[np.argmax(sp)])


def cli_phase(workdir: str, seed: int = 0) -> None:
    """The CLI in-process on synthetic WAVs made from `seed`."""
    from supersdr_jax import cli
    from supersdr_jax.io import wav
    from supersdr_jax.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer

    rng = np.random.default_rng(seed)
    # wideband: three AM carriers in a 1.2 MHz capture, 100 channels
    fs = 1_200_000
    t = np.arange(fs // 2) / fs
    z = (0.01 * (rng.normal(size=len(t)) + 1j * rng.normal(size=len(t))))
    carriers = [(-480_000, 700.0), (12_000, 1000.0), (300_000, 400.0)]
    for f_c, f_m in carriers:
        z = z + 0.3 * (1 + 0.8 * np.sin(2 * np.pi * f_m * t)) \
            * np.exp(2j * np.pi * f_c * t)
    src = os.path.join(workdir, "wb.wav")
    wav.write_kiwi_iq_wav(src, z.astype(np.complex64), fs)
    out = os.path.join(workdir, "chans")
    check(cli.main(["wideband", src, "-o", out, "--n-chan", "100",
                    "--mode", "AM", "--top", "3"]) == 0, "cli wideband")
    names = sorted(os.listdir(out))
    for f_c, f_m in carriers:
        hit = [nm for nm in names if f"{f_c / 1000:+.1f}kHz" in nm]
        check(len(hit) == 1, f"cli wideband: no channel at {f_c} Hz "
                             f"among {names}")
        data, rate = wav.read_audio_wav(os.path.join(out, hit[0]))
        peak = _tone_peak_hz(data, rate)
        check(abs(peak - f_m) < 20.0,
              f"cli wideband: {f_c} Hz channel peaks at {peak} Hz")
    print(f"cli wideband: top channels {names}, tones as modulated",
          flush=True)
    # demod: AM carrier at the capture centre, 800 Hz tone
    fs = 12000
    t = np.arange(fs * 3 // 512 * 512) / fs
    z = 0.3 * (1 + 0.6 * np.cos(2 * np.pi * 800.0 * t))
    src = os.path.join(workdir, "am.wav")
    wav.write_kiwi_iq_wav(src, z.astype(np.complex64), fs)
    dst = os.path.join(workdir, "am_audio.wav")
    check(cli.main(["demod", src, "-o", dst, "--mode", "AM",
                    "--agc-off"]) == 0, "cli demod")
    data, rate = wav.read_audio_wav(dst)
    peak = _tone_peak_hz(data, rate)
    check(rate == 48000 and abs(peak - 800.0) < 10.0,
          f"cli demod: tone at {peak} Hz, rate {rate}")
    print(f"cli demod: {len(data)} samples at {rate} Hz, tone {peak:.1f} Hz",
          flush=True)
    # waterfall
    png = os.path.join(workdir, "wf.png")
    check(cli.main(["waterfall", src, "-o", png, "--avg", "4"]) == 0,
          "cli waterfall")
    from supersdr_jax.display.png import read_png_size
    w, h = read_png_size(png)
    check(w == 1024 and h > 10, f"cli waterfall: png {w}x{h}")
    print(f"cli waterfall: png {w}x{h}", flush=True)
    # kiwi: live session against the loopback fake server, USB 1 kHz tone
    t = np.arange(512 * 64) / fs
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    server = FakeKiwiServer(FakeKiwiConfig(iq_source=iq, n_frames=48,
                                           audio_rate_true=12000.0)).start()
    live = os.path.join(workdir, "live.wav")
    try:
        rc = cli.main(["kiwi", "-s", "127.0.0.1", "-p", str(server.port),
                       "-f", "14200", "--mode", "USB", "-o", live,
                       "--frames", "40", "-b", "4"])
    finally:
        server.stop()
    check(rc == 0, "cli kiwi")
    data, rate = wav.read_audio_wav(live)
    peak = _tone_peak_hz(data, rate)
    check(len(data) > 4 * 2048 and abs(peak - 1000.0) < 20.0,
          f"cli kiwi: {len(data)} samples, tone at {peak} Hz")
    print(f"cli kiwi: {len(data)} samples from the fake KiwiSDR, tone "
          f"{peak:.1f} Hz", flush=True)


def mesh_phase(base: dict, tuning: dict, n_dev: int = 4,
               n_chunks: int = 2) -> None:
    """parallel/sharded_wideband over an n_dev mesh against the serial
    pipeline on one device, both in bin order, state chained."""
    import jax

    from supersdr_jax.parallel import sharded_wideband
    from supersdr_jax.runtime import wideband

    cfg = wideband.WidebandConfig(**base, **tuning)
    mesh = sharded_wideband.make_mesh(jax.devices()[:n_dev])
    proc = sharded_wideband.build(cfg, mesh)
    params = wideband.make_params(cfg)
    m_state = s_state = wideband.init_state(cfg)
    for k in range(n_chunks):
        iq = device_iq(cfg.chunk_in, seed=10 + k)
        t0 = time.perf_counter()
        m_state, m_audio, _ = proc(params, m_state, iq)
        jax.block_until_ready(m_audio)
        m_s = time.perf_counter() - t0
        s_state, s_out = wideband.process(cfg, params, s_state, iq)
        got = np.asarray(m_audio, np.float32)
        want = np.asarray(s_out.audio, np.float32)
        check(got.shape == want.shape, f"mesh {got.shape} vs {want.shape}")
        den = float(np.linalg.norm(got - want))
        snr = 20.0 * np.log10(float(np.linalg.norm(want))
                              / max(den, 1e-30))
        print(f"mesh chunk {k}: {n_dev} devices vs serial, audio "
              f"{got.shape}, SNR {snr:.2f} dB (tolerance ≥ "
              f"{MESH_GATE_DB} dB; rows in bin order on both sides); "
              f"mesh call {m_s:.3f} s", flush=True)
        check(bool(np.isfinite(got).all()) and snr >= MESH_GATE_DB,
              f"mesh diverges from serial on chunk {k}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args()

    card = card_lines()
    print("nvidia-smi name, power.limit:", flush=True)
    print(card, flush=True)
    gpu_tests = None if args.four else run_gpu_tests()

    sys.path.insert(0, REPO)
    import bench
    from supersdr_jax import backend
    from supersdr_jax.runtime import wideband

    backend.enable_compile_cache()
    if args.four:
        dev = device_info(expect_count=4)
        mesh_phase(bench.HEADLINE, wideband.PROFILES["fast"])
    else:
        dev = device_info()
        compile_phase(bench.HEADLINE, wideband.PROFILES)
        checks = gate_phase(wideband.PROFILES)
        i16_phase(bench.HEADLINE, wideband.PROFILES["fast"])
        tail_phase()
        headline_phase(bench.HEADLINE, wideband.PROFILES["fast"],
                       checks["fast"]["audio_mean_abs_mid"], card)
        with tempfile.TemporaryDirectory() as tmp:
            cli_phase(tmp)
        rc, log = gpu_tests
        print("gpu-marked tests:", log.splitlines()[-1] if log else "",
              flush=True)
        check(rc == 0, f"gpu-marked tests failed (rc {rc}):\n{log}")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
