"""chip_smoke.py's four-card phase on four of the virtual CPU devices
(tests/conftest.py): each sharded path equals one device bit for bit and
its result lands on all four devices."""

import jax
import pytest

import chip_smoke as cs
from dcsexplorer_tpu.refdec import decoder as rd


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    assert len(devs) >= 4, "tests/conftest.py gives the CPU 8 devices"
    return devs[:4]


def test_four_card_flat_sweep(devices):
    rom94, _ = cs.make_rom(rd.OS94, cs._assets("*.dcs94"), 128 * 1024, 2,
                           seed=0)
    row = cs.four_flat_sweep(rom94, devices)
    assert row["frames"] > 1000


def test_four_card_sessions(devices):
    rom94s, _ = cs.make_rom(rd.OS94, cs._assets("*.dcs94"), 256 * 1024, 1,
                            seed=2)
    row = cs.four_sessions(rom94s, 6, 40, 0, devices)
    assert row["sessions"] == 6


def test_four_card_tracks_frames_mesh(devices):
    row = cs.four_tracks_frames(devices)
    assert row["streams"] == 4 and row["frames"] % 2 == 0


def test_phase_four_cards_refuses_fewer_devices(devices):
    with pytest.raises(RuntimeError):
        cs.phase_four_cards(b"", b"", 1, 1, 0, devices[:3])
