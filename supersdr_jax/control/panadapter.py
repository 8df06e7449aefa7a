"""Panadapter state machine: zoom / span / counter math and tuning rules.

Reproduces `kiwi_waterfall`'s frequency bookkeeping
(/root/reference/utils_supersdr.py:592-878) decoupled from any server or
display:

  * span = max_freq / 2^zoom, zoom 0..14 (zoom_to_span, :747-751)
  * start-frequency quantization to the 2^MAX_ZOOM · WF_BINS counter grid
    (start_frequency_to_counter, :753-758)
  * edge clamping on tune/zoom (set_freq_zoom, :815-845)
  * bins ↔ kHz mapping (offset_to_bin/bins_to_khz, :765-778)
  * major/minor tick generation (gen_div, :697-717)
  * CW dial convention: displayed carrier = dial + CW_PITCH
    (supersdr.py:430-434,664,709)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from supersdr_jax.ops.passband import CW_PITCH_HZ


@dataclass
class Panadapter:
    max_freq_khz: float = 30000.0
    max_zoom: int = 14
    wf_bins: int = 1024
    zoom: int = 0
    freq_khz: float = 14200.0   # span center
    min_bin_spacing: int = 100

    def __post_init__(self):
        self.set_freq_zoom(self.freq_khz, self.zoom)

    # ------------------------------------------------------------ math

    @property
    def center_freq_khz(self) -> float:
        return self.max_freq_khz / 2

    def zoom_to_span(self, zoom: int | None = None) -> float:
        z = self.zoom if zoom is None else zoom
        assert 0 <= z <= self.max_zoom
        return self.max_freq_khz / 2 ** z

    @property
    def span_khz(self) -> float:
        return self.zoom_to_span()

    @property
    def start_f_khz(self) -> float:
        return self._start_f

    @property
    def end_f_khz(self) -> float:
        return self._start_f + self.span_khz

    @property
    def bins_per_khz(self) -> float:
        return self.wf_bins / self.span_khz

    def start_frequency_to_counter(self, start_khz: float) -> tuple[int, float]:
        """Quantize a start frequency onto the server counter grid; returns
        (counter, actual_start_khz)."""
        assert 0 <= start_khz <= self.max_freq_khz
        counter = round(start_khz / self.max_freq_khz
                        * 2 ** self.max_zoom * self.wf_bins)
        actual = counter * self.max_freq_khz / self.wf_bins / 2 ** self.max_zoom
        return counter, actual

    def offset_to_bin(self, offset_khz: float) -> float:
        return self.bins_per_khz * offset_khz

    def bins_to_khz(self, bins: float) -> float:
        return bins / self.bins_per_khz + self.start_f_khz

    def deltabins_to_khz(self, bins: float) -> float:
        return bins / self.bins_per_khz

    # ----------------------------------------------------------- tuning

    def set_freq_zoom(self, freq_khz: float, zoom: int) -> float:
        """Center the span at freq (kHz) with edge clamping; returns the
        effective center (set_freq_zoom semantics, utils:815-845)."""
        zoom = max(0, min(self.max_zoom, zoom))
        self.zoom = zoom
        self.freq_khz = freq_khz
        span = self.zoom_to_span()
        if zoom == 0:
            self.freq_khz = self.center_freq_khz
        else:
            if self.freq_khz - span / 2 < 0:
                self.freq_khz = span / 2
            elif self.freq_khz + span / 2 > self.max_freq_khz:
                self.freq_khz = self.max_freq_khz - span / 2
        self.counter, self._start_f = self.start_frequency_to_counter(
            self.freq_khz - span / 2)
        return self.freq_khz

    def zoom_in(self, dial_khz: float | None = None) -> float:
        return self.set_freq_zoom(dial_khz if dial_khz is not None
                                  else self.freq_khz, self.zoom + 1)

    def zoom_out(self, dial_khz: float | None = None) -> float:
        return self.set_freq_zoom(dial_khz if dial_khz is not None
                                  else self.freq_khz, self.zoom - 1)

    def page(self, direction: int) -> float:
        """PAGE UP/DOWN: shift by span/4 (supersdr.py help table)."""
        return self.set_freq_zoom(self.freq_khz
                                  + direction * self.span_khz / 4, self.zoom)

    def click_to_dial_khz(self, bin_x: float, mode: str) -> float:
        """Waterfall click → dial frequency, honoring the CW pitch offset
        (supersdr.py:709)."""
        f = self.bins_to_khz(bin_x)
        if mode.upper() == "CW":
            f -= CW_PITCH_HZ / 1000.0
        return f

    def dial_to_display_khz(self, dial_khz: float, mode: str) -> float:
        """Where the carrier shows on the scope (supersdr.py:430-434)."""
        if mode.upper() == "CW":
            return dial_khz + CW_PITCH_HZ / 1000.0
        return dial_khz

    def contains(self, dial_khz: float) -> bool:
        return self.start_f_khz <= dial_khz <= self.end_f_khz

    def follow(self, dial_khz: float) -> bool:
        """WF↔RX link behavior: when the dial leaves the span, shift the
        span to put the dial at the nearest edge (supersdr.py:851-857).
        Returns True if the span moved."""
        if dial_khz < self.start_f_khz:
            self.set_freq_zoom(self.start_f_khz, self.zoom)
            return True
        if dial_khz > self.end_f_khz:
            self.set_freq_zoom(self.end_f_khz, self.zoom)
            return True
        return False

    # ------------------------------------------------------------ ticks

    def gen_div(self) -> tuple[list[int], list[int]]:
        """Major/minor tick bins (gen_div semantics, utils:697-717):
        propose 10 kHz spacing, scale ×10 until ticks are ≥ min_bin_spacing
        pixels apart (minors at /10)."""
        space = 10.0
        div, subdiv = [], []
        f_s, f_e = int(self.start_f_khz), int(self.end_f_khz)
        while not div and not subdiv:
            if self.bins_per_khz * space > self.min_bin_spacing:
                div = [int(self.offset_to_bin(f - self.start_f_khz))
                       for f in range(f_s, f_e + 1) if not f % space]
            if self.bins_per_khz * space / 10 > self.min_bin_spacing / 10:
                subdiv = [int(self.offset_to_bin(f - self.start_f_khz))
                          for f in range(f_s, f_e + 1) if not f % (space / 10)]
            space *= 10
            if space > self.max_freq_khz * 10:
                break
        return div, subdiv
