"""KiwiSDR streaming client (SND / W/F) over the native WebSocket transport.

Reproduces the observable behavior of the reference's two client layers —
the generic library client (kiwi/client.py:108-549) and the app-level
session classes (`kiwi_waterfall.start_stream` utils_supersdr.py:719-745,
`kiwi_sound.__init__` :960-994) — as one reusable class:

 * auth + per-stream setup command sequences
 * MSG parameter handling incl. the full error taxonomy
   (too_busy / badp / down → typed exceptions, kiwi/client.py:93-106,323-329)
 * negotiation: audio_init (KIWI_RATE and the true, drifting rate),
   center_freq/bandwidth, wf_fft_size/zoom_max/fps
 * SND parsing: int16 audio, ADPCM-compressed audio, IQ with GPS header
 * W/F parsing incl. ADPCM-compressed rows (decoder reset per row, 10-tail
   trim — kiwi/client.py:477-480)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from supersdr_jax.io import kiwi_protocol as kp
from supersdr_jax.io import websocket
from supersdr_jax.ops import adpcm


class KiwiError(Exception):
    pass


class KiwiTooBusyError(KiwiError):
    pass


class KiwiDownError(KiwiError):
    pass


class KiwiBadPasswordError(KiwiError):
    pass


class KiwiTimeLimitError(KiwiError):
    pass


class KiwiServerTerminatedConnection(KiwiError):
    pass


@dataclass
class KiwiStreamInfo:
    """Parameters learned from the server during negotiation."""
    sample_rate: float | None = None       # MSG sample_rate
    audio_rate: int | None = None          # nominal (MSG audio_init audio_rate)
    audio_rate_true: float | None = None   # true, drifting rate
    max_freq_khz: float = 30000.0          # from center_freq/bandwidth
    wf_bins: int = 1024
    max_zoom: int = 14
    max_fps: int = 23
    version_major: int | None = None
    version_minor: int | None = None


class KiwiClient:
    """One stream (SND or W/F) to one KiwiSDR server."""

    def __init__(self, host: str, port: int, password: str = "",
                 stream_type: str = "SND", ident: str = "supersdr_jax",
                 timestamp: int | None = None):
        if stream_type not in ("SND", "W/F"):
            raise ValueError(stream_type)
        self.host, self.port = host, port
        self.password = password
        self.stream_type = stream_type
        self.ident = ident
        self.timestamp = timestamp or int(time.time())
        self.ws: websocket.WebSocket | None = None
        self.info = KiwiStreamInfo()
        self.modulation = "am"
        self.compression = False
        self._adpcm = adpcm.AdpcmState()

    # ------------------------------------------------------------ connect

    def connect(self) -> None:
        resource = f"/{self.timestamp}/{self.stream_type}"
        self.ws = websocket.connect(self.host, self.port, resource)
        self.send(kp.auth(self.password))

    def send(self, message: str) -> None:
        assert self.ws is not None, "not connected"
        self.ws.send(message)

    def close(self) -> None:
        if self.ws is not None:
            self.ws.close()
            self.ws = None

    # ------------------------------------------------------- setup bursts

    def setup_sound(self, mode: str, low_cut: int, high_cut: int,
                    freq_khz: float, agc_on: bool = True, hang: bool = False,
                    thresh: int = -80, slope: int = 0, decay: int = 4000,
                    gain: int = 50, compression: bool = False,
                    ar_in: int = 12000, ar_out: int = 48000) -> None:
        """The kiwi_sound connect burst (utils_supersdr.py:976-983)."""
        self.modulation = mode.lower()
        self.compression = compression
        for msg in (kp.set_mod(mode, low_cut, high_cut, freq_khz),
                    kp.set_compression(compression),
                    kp.ident_user(self.ident),
                    kp.set_inactivity_override(1000),
                    kp.set_agc(agc_on, hang, thresh, slope, decay, gain),
                    kp.set_ar_ok(ar_in, ar_out)):
            self.send(msg)

    def setup_waterfall(self, zoom: int, counter: int, maxdb: int = -10,
                        mindb: int = -110, speed: int = 4,
                        comp: bool = False, interp: int = 13) -> None:
        """The kiwi_waterfall connect burst (utils_supersdr.py:741-742)."""
        for msg in (kp.set_zoom_start(zoom, counter),
                    kp.set_maxdb_mindb(maxdb, mindb),
                    kp.set_wf_speed(speed),
                    kp.set_wf_comp(comp),
                    kp.set_wf_interp(interp)):
            self.send(msg)
        self.compression = comp

    # ------------------------------------------------------------ receive

    def _handle_msg(self, msg: kp.Msg) -> None:
        p = msg.params
        if "too_busy" in p:
            raise KiwiTooBusyError(
                f"{self.host}: all {p['too_busy']} client slots taken")
        if p.get("badp") == "1":
            raise KiwiBadPasswordError(f"{self.host}: bad password")
        if "down" in p:
            raise KiwiDownError(f"{self.host}: server is down atm")
        if "audio_rate" in p and "audio_init" not in p:
            self.info.audio_rate = int(float(p["audio_rate"]))
        if "audio_init" in p:
            if "audio_rate" in p:
                self.info.audio_rate = int(float(p["audio_rate"]))
            if "sample_rate" in p:
                self.info.audio_rate_true = float(p["sample_rate"])
        elif "sample_rate" in p:
            self.info.sample_rate = float(p["sample_rate"])
        if "bandwidth" in p:
            self.info.max_freq_khz = float(p["bandwidth"]) / 1000.0
        if "wf_fft_size" in p:
            self.info.wf_bins = int(p["wf_fft_size"])
        if "zoom_max" in p:
            self.info.max_zoom = int(p["zoom_max"])
        if "wf_fps_max" in p:
            self.info.max_fps = int(p["wf_fps_max"])
        if "version_maj" in p:
            self.info.version_major = int(p["version_maj"])
        if "version_min" in p:
            self.info.version_minor = int(p["version_min"])

    def read(self):
        """Receive and parse one message. Returns kp.Msg / kp.SndFrame /
        kp.WfFrame; raises the Kiwi error taxonomy."""
        assert self.ws is not None, "not connected"
        try:
            raw = self.ws.receive()
        except websocket.ConnectionTerminated:
            raise KiwiServerTerminatedConnection(
                "server closed the connection unexpectedly") from None
        if raw is None:
            raise KiwiServerTerminatedConnection(
                "server closed the connection cleanly")
        parsed = kp.parse(raw)
        if isinstance(parsed, kp.Msg):
            self._handle_msg(parsed)
        return parsed

    def wait_for_stream(self, max_msgs: int = 200):
        """Drain MSG until the first data frame arrives (the reference's
        connect loops, utils_supersdr.py:671-689, 984-994). Returns it."""
        for _ in range(max_msgs):
            parsed = self.read()
            if isinstance(parsed, (kp.SndFrame, kp.WfFrame)):
                return parsed
        raise KiwiError("no data frame within message budget")

    # ------------------------------------------------- payload decoding

    def snd_samples(self, frame: kp.SndFrame):
        """Decode a SND frame per the negotiated mode/compression.
        Returns ('iq', gps, complex64) or ('audio', None, int16)."""
        if self.modulation == "iq":
            gps, z = frame.iq_samples()
            return "iq", gps, z
        if self.compression:
            samples = adpcm.decode_np(frame.payload, self._adpcm)
            return "audio", None, samples
        return "audio", None, frame.audio_int16()

    def snd_samples_i16(self, frame: kp.SndFrame):
        """IQ frames as INT16 planes: ('iq16', gps, (re_i16, im_i16)) —
        feed straight into wideband.process_i16 / i16 mesh chunks (the
        r5 wire→kernel path: no float conversion, half the transfer).
        Non-IQ frames fall through to `snd_samples`."""
        if self.modulation == "iq":
            gps, re, im = frame.iq_samples_i16()
            return "iq16", gps, (re, im)
        return self.snd_samples(frame)

    def wf_bins(self, frame: kp.WfFrame) -> np.ndarray:
        if self.compression:
            dec = adpcm.decode_np(frame.payload)  # fresh state per row
            return np.asarray(dec[: len(dec) - 10], np.int16).astype(np.uint8)
        return frame.bins_uint8()

    def keepalive(self) -> None:
        self.send(kp.keepalive())
