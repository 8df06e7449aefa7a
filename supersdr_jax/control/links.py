"""Link-state machine: WF ↔ RX ↔ CAT coordination.

The reference's main loop wires three tunable things together — waterfall
span, receiver dial, CAT transceiver — through three flags
(wf_snd_link, cat_snd_link, wf_cat_link). This module reproduces that
event logic headlessly (/root/reference/supersdr.py:826-921):

  manual/keyboard tune  → RX follows; span follows iff wf_snd_link, else
                          span only shifts when the dial leaves it;
                          auto-mode may swap the mode from the band plan
  waterfall click       → RX to clicked freq (CW pitch corrected); span
                          recentered iff wf_snd_link
  CAT push (cat_snd_link) → dial/mode pushed to the radio (CW pitch added)
  CAT poll              → radio VFO turned by hand: RX follows the radio,
                          span shifts by half-span steps when the dial
                          walks out (or recenters on a big jump)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from supersdr_jax.control.bandplan import get_auto_mode
from supersdr_jax.control.panadapter import Panadapter
from supersdr_jax.control.receiver import Flags, Receiver
from supersdr_jax.ops.passband import CW_PITCH_HZ

CW_PITCH_KHZ = CW_PITCH_HZ / 1000.0


@dataclass
class LinkController:
    wf: Panadapter
    rx: Receiver
    flags: Flags = field(default_factory=Flags)
    cat = None  # optional CatClient-like object

    def _cat_pitch(self) -> float:
        return CW_PITCH_KHZ if self.rx.radio_mode == "CW" else 0.0

    # ------------------------------------------------------------ events

    def manual_tune(self, freq_khz: float) -> None:
        """Keyboard/frequency-entry tune (supersdr.py:836-857)."""
        if self.flags.wf_snd_link:
            eff = self.wf.set_freq_zoom(freq_khz, self.wf.zoom)
            self.rx.tune(eff, auto_mode=self.flags.auto_mode)
        else:
            self.rx.tune(freq_khz, auto_mode=self.flags.auto_mode)
            self.wf.follow(self.rx.freq)
        self._push_cat()

    def click_tune(self, bin_x: float) -> None:
        """Waterfall click (supersdr.py:864-873 + :709)."""
        freq = self.wf.click_to_dial_khz(bin_x, self.rx.radio_mode)
        self.rx.tune(freq, auto_mode=self.flags.auto_mode)
        if self.flags.wf_snd_link:
            self.wf.set_freq_zoom(freq, self.wf.zoom)
        self._push_cat()

    def set_mode(self, mode: str) -> None:
        self.rx.set_mode(mode)
        if self.cat is not None and self.flags.cat_snd_link:
            self.cat.set_mode(self.rx.radio_mode)

    def zoom(self, direction: int) -> None:
        """UP/DOWN zoom centered on the RX dial (supersdr.py:428-434)."""
        center = self.rx.freq + self._cat_pitch()
        self.wf.set_freq_zoom(center, self.wf.zoom + direction)

    def _push_cat(self) -> None:
        if self.cat is not None and self.flags.cat_snd_link:
            self.cat.set_freq(self.rx.freq + self._cat_pitch())
            if self.flags.auto_mode and \
                    self.cat.radio_mode != get_auto_mode(self.rx.freq):
                self.cat.set_mode(self.rx.radio_mode)

    _last_cat_freq: float | None = None
    _last_cat_mode: str | None = None

    def poll_cat(self) -> bool:
        """Reverse path: notice the radio's VFO moving
        (supersdr.py:883-921). Returns True if the RX was retuned."""
        if self.cat is None or not self.flags.cat_snd_link:
            return False
        new_mode = self.cat.get_mode()
        if (self._last_cat_mode is not None
                and self._last_cat_mode != new_mode
                and new_mode in ("USB", "LSB", "CW", "AM")):
            self.rx.set_mode(new_mode)
        self._last_cat_mode = new_mode
        old_freq = self._last_cat_freq
        self.cat.get_freq()
        self._last_cat_freq = self.cat.freq
        if old_freq is None or self.cat.freq == old_freq:
            return False
        self.rx.tune(self.cat.freq - self._cat_pitch())
        if self.flags.wf_cat_link:
            delta = self.rx.freq - self.wf.freq_khz
            if abs(delta) < 5 * self.wf.span_khz:
                if delta + self.wf.span_khz / 2 < 0:
                    self.wf.set_freq_zoom(self.wf.start_f_khz, self.wf.zoom)
                elif delta - self.wf.span_khz / 2 > 0:
                    self.wf.set_freq_zoom(self.wf.end_f_khz, self.wf.zoom)
            else:
                self.wf.set_freq_zoom(self.cat.freq, self.wf.zoom)
        return True
