"""chip_smoke.py at tiny sizes on the CPU: the ROM generator, the cold
catalogue phase, and the refusal to run anywhere but on a GPU."""

import numpy as np
import pytest

import chip_smoke as cs
from dcsexplorer_tpu.refdec import decoder as rd

KIB = 1024


@pytest.fixture(scope="module")
def roms():
    return cs.rom_sets(0, chip_94=128 * KIB, chip_93=128 * KIB, n_chips=2,
                       n_chips_session=2)


@pytest.fixture(scope="module")
def pool():
    with cs.reference_pool(2) as p:
        yield p


def test_make_rom_fills_its_chips_and_respects_the_frame_cap():
    assets = cs._assets("*.dcs94")
    zip_bytes, n = cs.make_rom(rd.OS94, assets, 256 * KIB, 2, seed=3)
    streams = cs.rom_streams(cs.load_rom(zip_bytes))
    assert len(streams) == n > len(assets)
    # each stream cut from the ROM is an asset (count + header + body)
    for s in streams:
        assert any(s[:len(a)] == a[:len(s)] for a in assets)
    used = sum(len(s) for s in streams)
    assert used > 0.8 * 2 * 256 * KIB          # the chips are full

    cap = 1500
    zip_bytes, n_cap = cs.make_rom(rd.OS94, assets, 256 * KIB, 2, seed=3,
                                   max_frames=cap)
    frames = sum(cs._n_frames(s)
                 for s in cs.rom_streams(cs.load_rom(zip_bytes)))
    assert n_cap < n and frames <= cap


def test_catalogue_phase_tiny(roms, pool):
    row = cs.phase_catalogue(roms, 200, 0, pool)
    assert row["ok"] and row["native_runtime"] is True
    fams = row["families"]
    assert set(fams) == {"rom94", "rom93b", "rom93a1"}
    for name, fam in fams.items():
        assert fam["frames"] > 1000 and fam["compared_frames"] >= 200, name
    assert row["autoplay"]["tracks"] == fams["rom94"]["streams"]
    assert row["compared_frames"]["autoplay"] >= 200


def test_main_refuses_a_cpu_platform(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_session_events_are_distinct_six_voice_sessions():
    zip_bytes, n = cs.make_rom(rd.OS94, cs._assets("*.dcs94"), 256 * KIB, 2,
                               seed=1)
    assert n >= 6
    rs = cs.load_rom(zip_bytes)
    evs = cs.session_events(rs, 8, seed=5)
    assert len({repr(sorted(e.items())) for e in evs}) == 8
    for e in evs:
        starts = [b for f, bs in e.items() for b in bs]
        assert starts[:2] == [0x55, 0xAA]          # master volume first
        assert len(starts) == 4 + 2 * 6             # one track per voice
