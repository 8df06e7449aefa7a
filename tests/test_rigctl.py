import socket
import threading
import time

import pytest

from supersdr_jax.io.rigctl import CatClient, RigctldServer


class FakeRig:
    """Minimal TunableRig for the emulator tests."""

    def __init__(self):
        self.freq_khz = 14200.0
        self.mod = "usb"
        self.lc, self.hc = 30, 3000
        self.calls = []

    def get_frequency(self):
        return self.freq_khz

    def get_mod(self):
        return self.mod

    def get_lowcut(self):
        return self.lc

    def get_highcut(self):
        return self.hc

    def set_mod(self, mod, lc, hc, freq_khz):
        self.calls.append((mod, lc, hc, freq_khz))
        self.mod = mod.lower()
        if hc is not None:
            self.hc = hc
        self.freq_khz = freq_khz


@pytest.fixture
def served_rig():
    rig = FakeRig()
    server = RigctldServer(rig, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield rig, server
    server.close()


def raw_cmd(port, cmd, n_lines=1):
    s = socket.create_connection(("127.0.0.1", port), timeout=3)
    s.sendall((cmd + "\n").encode())
    time.sleep(0.05)
    out = s.recv(65536).decode()
    s.close()
    return out


def test_get_freq(served_rig):
    rig, server = served_rig
    assert raw_cmd(server.port, "f") == "14200000\n"


def test_set_freq(served_rig):
    rig, server = served_rig
    out = raw_cmd(server.port, "F 7074000")
    assert out == "RPRT 0\n"
    assert rig.freq_khz == 7074.0


def test_get_mode(served_rig):
    rig, server = served_rig
    assert raw_cmd(server.port, "m") == "USB\n3000\n"


def test_set_mode(served_rig):
    rig, server = served_rig
    out = raw_cmd(server.port, "M CW 500")
    assert out == "RPRT 0\n"
    assert rig.mod == "cw"
    assert rig.hc == 500


def test_dump_state_and_chk_vfo(served_rig):
    rig, server = served_rig
    out = raw_cmd(server.port, "\\dump_state")
    assert out.endswith("done\n")
    assert raw_cmd(server.port, "\\chk_vfo") == "0\n"


def test_vfo_and_split(served_rig):
    rig, server = served_rig
    assert raw_cmd(server.port, "v") == "VFOA\n"
    assert raw_cmd(server.port, "s") == "0\nVFOA\n"


def test_cat_client_against_emulator(served_rig):
    rig, server = served_rig
    cat = CatClient("127.0.0.1", server.port)
    assert cat.cat_ok
    assert cat.freq == 14200.0
    assert cat.radio_mode == "USB"
    cat.set_freq(7100.0)
    time.sleep(0.05)
    assert rig.freq_khz == 7100.0
    cat.set_mode("CW")
    time.sleep(0.05)
    assert rig.mod == "cw"
    cat.close()


def test_cat_client_degrades_without_server():
    cat = CatClient("127.0.0.1", 1)  # nothing listening
    assert not cat.cat_ok
