"""Randomized long-session lockstep fuzz: the device session path must match
the scalar runtime bit-for-bit over hundreds of frames of random track
commands, master/channel volume changes, and overlapping voices."""

import numpy as np
import pytest

from dcsexplorer_tpu.compiler import romgen
from dcsexplorer_tpu.models import romplay
from dcsexplorer_tpu.refdec import decoder as rd
from dcsexplorer_tpu.rom import zipload

from .test_romgen import _make_spec


def _rom():
    rs, _ = zipload.load_zip_data(romgen.RomBuilder(_make_spec()).build_zip())
    assert rs.check() == 1
    return rs


@pytest.mark.parametrize("seed", [5, 6])
def test_session_fuzz_lockstep(seed):
    rs = _rom()
    rng = np.random.default_rng(seed)
    n_frames = 500
    playable = [1, 2, 4, 5, 7]        # type-1 tracks in the synthetic ROM

    events = {}
    f = 0
    while f < n_frames - 4:
        kind = rng.integers(0, 10)
        byts = []
        if kind < 6:                                 # track command
            t = int(rng.choice(playable))
            byts = [(t >> 8) & 0xFF, t & 0xFF]
        elif kind < 8:                               # master volume
            v = int(rng.integers(0, 256))
            byts = [0x55, 0xAA, v, v ^ 0xFF]
        else:                                        # channel volume
            ch = int(rng.integers(0, 6))
            v = int(rng.integers(0, 256))
            byts = [0x55, 0xAB + ch, v, v ^ 0xFF]

        def mk(bb):
            def ev(dec):
                for b in bb:
                    dec.write_data_port(b)
            return ev
        events[f] = mk(byts)
        f += int(rng.integers(2, 25))

    pcm, tracer = romplay.play_session(rs, events, n_frames,
                                       default_volume=0x80)

    dec = rd.ReferenceDecoder()
    dec.default_volume = 0x80
    dec.load_rom_set(rs)
    dec.soft_boot()
    golden = []
    for fr in range(n_frames):
        if fr in events:
            events[fr](dec)
        golden.extend(dec.next_samples(240))
    golden = np.array(golden, dtype=np.int16)

    assert np.abs(pcm).max() > 0
    mism = np.nonzero(golden != pcm)[0]
    assert mism.size == 0, (
        f"seed {seed}: {mism.size} mismatches, first at {mism[0]} "
        f"(frame {mism[0] // 240})")
    assert list(tracer.host.rx) == list(dec.host.rx)


def _rom93():
    """A 93B-format ROM: same track programs, streams re-encoded to 93b."""
    import os

    from dcsexplorer_tpu.encoder import encoder as enc
    from dcsexplorer_tpu.utils import audioio

    spec = _make_spec()
    spec.os_version = rd.OS93B
    assets = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets")
    new_streams = {}
    names = list(spec.streams)
    for name, wav in zip(names, ("chime.wav", "thump.wav")):
        pcm, rate = audioio.read_wav(os.path.join(assets, wav))
        s, _ = enc.encode_pcm(pcm * 32768.0, enc.CompressionParams(),
                              sample_rate=rate, os_version=rd.OS93B)
        new_streams[name] = s
    spec.streams = new_streams
    rs, _ = zipload.load_zip_data(romgen.RomBuilder(spec).build_zip())
    assert rs.check() == 1
    assert rs.os_version == rd.OS93B
    return rs


def test_session_fuzz_lockstep_93(seed=21):
    """The 93-family device pipeline matches the scalar runtime over a
    fuzzed session on a compiler-generated 93B ROM."""
    rs = _rom93()
    rng = np.random.default_rng(seed)
    n_frames = 300
    playable = [1, 2, 4, 5, 7]

    events = {}
    f = 0
    while f < n_frames - 4:
        kind = rng.integers(0, 10)
        if kind < 6:
            t = int(rng.choice(playable))
            byts = [(t >> 8) & 0xFF, t & 0xFF]
        elif kind < 8:
            v = int(rng.integers(0, 256))
            byts = [0x55, 0xAA, v, v ^ 0xFF]
        else:
            ch = int(rng.integers(0, 6))
            v = int(rng.integers(0, 256))
            byts = [0x55, 0xAB + ch, v, v ^ 0xFF]

        def mk(bb):
            def ev(dec):
                for b in bb:
                    dec.write_data_port(b)
            return ev
        events[f] = mk(byts)
        f += int(rng.integers(2, 25))

    pcm, tracer = romplay.play_session(rs, events, n_frames,
                                       default_volume=0x80)

    dec = rd.ReferenceDecoder()
    dec.default_volume = 0x80
    dec.load_rom_set(rs)
    dec.soft_boot()
    golden = []
    for fr in range(n_frames):
        if fr in events:
            events[fr](dec)
        golden.extend(dec.next_samples(240))
    golden = np.array(golden, dtype=np.int16)

    assert np.abs(pcm).max() > 0
    mism = np.nonzero(golden != pcm)[0]
    assert mism.size == 0, (
        f"93 session: {mism.size} mismatches, first at {mism[0]} "
        f"(frame {mism[0] // 240})")
    assert list(tracer.host.rx) == list(dec.host.rx)
