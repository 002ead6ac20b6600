"""SessionServer (batched pipelined serving) vs per-session play_session.

play_session is device-decode validated against the scalar decoder
(test_romplay.py), which is lockstep-validated against the compiled
reference — so PCM equality here extends the bit-exactness chain to the
batched serving surface (segment trace in C, wire pack/unpack, segment
reconstruction, vmapped decode).
"""

import numpy as np
import pytest

from dcsexplorer_tpu.models import romplay
from dcsexplorer_tpu.rom import zipload
from dcsexplorer_tpu.compiler import romgen

from .test_romgen import _make_spec


def _rom_set():
    zip_bytes = romgen.RomBuilder(_make_spec()).build_zip()
    rs, _ = zipload.load_zip_data(zip_bytes, zip_name="synth.zip")
    assert rs.check() == 1
    return rs


def _byte_events(b):
    """Session b's port-byte schedule (dict of frame -> [bytes]):
    staggered track starts plus a master-volume command."""
    ev = {}
    for t in (1, 2, 3):
        ev.setdefault((b * 11 + t * 7) % 40, []).extend([0x00, t])
    vol = 0x50 + 8 * b
    ev.setdefault(0, []).extend([0x55, 0xAA, vol & 0xFF, (vol & 0xFF) ^ 0xFF])
    return ev


def _callable_events(byte_ev):
    """The same schedule as play_session's {frame: callable} form."""
    out = {}
    for f, bs in byte_ev.items():
        def ev(dec, bs=tuple(bs)):
            for b in bs:
                dec.write_data_port(b)
        out[f] = ev
    return out


def test_session_server_matches_play_session():
    rs = _rom_set()
    S, T = 3, 120
    bank = romplay.build_rom_bank(rs)
    batches = [[_byte_events(k * S + b) for b in range(S)]
               for k in range(2)]

    with romplay.SessionServer(rs, n_sessions=S, n_frames=T,
                               bank=bank) as srv:
        outs = list(srv.serve(batches))
    assert len(outs) == 2
    assert all(o.shape == (S, T * 240) and o.dtype == np.int16
               for o in outs)

    some_signal = False
    for k, batch in enumerate(batches):
        for b, byte_ev in enumerate(batch):
            golden, _ = romplay.play_session(
                rs, _callable_events(byte_ev), T, bank=bank)
            assert np.array_equal(outs[k][b], golden), (k, b)
            some_signal |= bool(np.abs(golden).max() > 0)
    assert some_signal


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_session_server_serves_more_batches_than_depth(depth):
    """Every batch of a stream longer than the pipeline depth comes out,
    in order, each equal to per-session play_session."""
    rs = _rom_set()
    S, T = 2, 40
    bank = romplay.build_rom_bank(rs)
    batches = [[_byte_events(k * S + b) for b in range(S)]
               for k in range(depth + 3)]

    with romplay.SessionServer(rs, n_sessions=S, n_frames=T, bank=bank,
                               depth=depth) as srv:
        outs = list(srv.serve(iter(batches)))
    assert len(outs) == len(batches)
    for k, batch in enumerate(batches):
        for b, byte_ev in enumerate(batch):
            golden, _ = romplay.play_session(
                rs, _callable_events(byte_ev), T, bank=bank)
            assert np.array_equal(outs[k][b], golden), (depth, k, b)


def test_session_server_segment_overflow_retry():
    """A lane needing more than the configured segment table forces the
    doubled-table retry path (recompile at the wider width)."""
    rs = _rom_set()
    S, T = 2, 120
    bank = romplay.build_rom_bank(rs)
    # rapid re-commands: every other frame restarts a track, so the row
    # lanes break into many segments
    busy = {f: [0x00, 1 + (f // 2) % 3] for f in range(0, T - 1, 2)}
    batch = [busy, _byte_events(0)]

    with romplay.SessionServer(rs, n_sessions=S, n_frames=T, seg_e=4,
                               bank=bank) as srv:
        out = srv.serve_one(batch)
        assert srv.seg_e > 4                       # the retry widened it
    golden, _ = romplay.play_session(rs, _callable_events(busy), T,
                                     bank=bank)
    assert np.array_equal(out[0], golden)


def test_session_server_reduce_fn():
    """A device-side reducer replaces the PCM fetch (serving hosts on a
    slow link fetch checksums, not waveforms)."""
    import jax.numpy as jnp
    rs = _rom_set()
    S, T = 2, 80
    bank = romplay.build_rom_bank(rs)
    batch = [_byte_events(0), _byte_events(1)]

    with romplay.SessionServer(
            rs, n_sessions=S, n_frames=T, bank=bank,
            reduce_fn=lambda pcm: jnp.sum(pcm & 0xFF, axis=1,
                                          dtype=jnp.int32)) as srv:
        red = srv.serve_one(batch)
    with romplay.SessionServer(rs, n_sessions=S, n_frames=T,
                               bank=bank) as srv:
        pcm = srv.serve_one(batch)
    assert red.shape == (S,)
    assert np.array_equal(red,
                          np.sum(np.asarray(pcm, np.int64) & 0xFF, axis=1))
