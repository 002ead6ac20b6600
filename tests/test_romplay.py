"""Device ROM playback (sessions + autoplay) vs. the scalar decoder.

The scalar decoder is itself lockstep-validated against the compiled
reference (test_romgen.py), so scalar parity here extends the bit-exactness
chain to the device ROM-playback path.
"""

import numpy as np

from dcsexplorer_tpu.models import romplay
from dcsexplorer_tpu.refdec import decoder as rd
from dcsexplorer_tpu.rom import zipload
from dcsexplorer_tpu.compiler import romgen

from .test_romgen import _make_spec


def _rom_set():
    zip_bytes = romgen.RomBuilder(_make_spec()).build_zip()
    rs, _ = zipload.load_zip_data(zip_bytes, zip_name="synth.zip")
    assert rs.check() == 1
    return rs


def _scalar_session(rs, events, n_frames, default_volume=0x67):
    dec = rd.ReferenceDecoder()
    dec.default_volume = default_volume
    dec.load_rom_set(rs)
    dec.soft_boot()
    out = []
    for f in range(n_frames):
        if f in events:
            events[f](dec)
        out.extend(dec.next_samples(240))
    return np.array(out, dtype=np.int16)


def test_device_session_matches_scalar():
    rs = _rom_set()

    def cmd(track):
        def ev(dec):
            dec.write_data_port((track >> 8) & 0xFF)
            dec.write_data_port(track & 0xFF)
        return ev

    events = {0: cmd(1), 30: cmd(2), 90: cmd(3), 95: cmd(4)}
    n = 160
    golden = _scalar_session(rs, events, n)
    got, _ = romplay.play_session(rs, events, n)
    assert np.array_equal(golden, got)
    assert np.abs(golden).max() > 0


def test_device_autoplay_matches_scalar():
    rs = _rom_set()
    pcm, schedule = romplay.autoplay(rs, tracks=[1, 2], pad_frames=3,
                                     max_frames_per_track=80)
    assert len(schedule) == 2

    events = {}
    for (t, frame, _) in schedule:
        def make_event(track):
            def ev(dec):
                dec.clear_tracks()
                dec.write_data_port((track >> 8) & 0xFF)
                dec.write_data_port(track & 0xFF)
            return ev
        events[frame] = make_event(t)
    total = pcm.size // 240
    golden = _scalar_session(rs, events, total)
    assert np.array_equal(golden, pcm)


def test_93_rom_autoplay_device_lockstep():
    """A 93-family ROM (streams encoded by this framework's 93 encoder)
    plays through the device session path bit-exactly vs the scalar decoder."""
    import numpy as np
    from dcsexplorer_tpu.compiler import romgen
    from dcsexplorer_tpu.encoder import encoder as enc
    from dcsexplorer_tpu.models import romplay
    from dcsexplorer_tpu.refdec import decoder as rd
    from dcsexplorer_tpu.rom import zipload
    from .test_romgen import _make_spec

    spec = _make_spec()
    spec.os_version = rd.OS93B
    t = np.arange(31250) / 31250.0
    for k, name in enumerate(list(spec.streams)):
        sig = (5000 * np.sin(2 * np.pi * (400 + 150 * k) * t)).astype(np.float32)
        spec.streams[name], _ = enc.encode_pcm(sig, os_version=rd.OS93B)
    rs, _ = zipload.load_zip_data(romgen.RomBuilder(spec).build_zip())
    assert rs.check() == 1 and rs.os_version == rd.OS93B

    pcm, sched, _ = romplay.autoplay(rs, max_frames_per_track=60,
                                     return_tracer=True)
    dec = rd.ReferenceDecoder()
    dec.default_volume = 0x67
    dec.load_rom_set(rs)
    dec.soft_boot()
    events = {}
    for (tno, frame, _) in sched:
        def mk(track):
            def ev(d):
                d.clear_tracks()
                d.write_data_port((track >> 8) & 0xFF)
                d.write_data_port(track & 0xFF)
            return ev
        events[frame] = mk(tno)
    golden = []
    for f in range(pcm.size // 240):
        if f in events:
            events[f](dec)
        golden.extend(dec.next_samples(240))
    golden = np.array(golden, dtype=np.int16)
    assert np.abs(pcm).max() > 0          # actually played audio
    assert np.array_equal(golden, pcm)


def test_93a_mixed_rom_autoplay_device_lockstep():
    """An OS93a ROM mixing a Type-1 (pair-table) stream with a format-0
    stream exercises both 93-family kernels chained per channel."""
    import numpy as np
    from dcsexplorer_tpu.compiler import romgen
    from dcsexplorer_tpu.encoder import encoder as enc
    from dcsexplorer_tpu.models import romplay
    from dcsexplorer_tpu.refdec import decoder as rd
    from dcsexplorer_tpu.rom import zipload
    from .test_format93 import build_stream93a_type1
    from .test_romgen import _make_spec

    spec = _make_spec()
    spec.os_version = rd.OS93A
    t = np.arange(31250 // 2) / 31250.0
    names = list(spec.streams)
    sig = (5000 * np.sin(2 * np.pi * 500 * t)).astype(np.float32)
    spec.streams[names[0]], _ = enc.encode_pcm(
        sig, enc.CompressionParams(stream_format_type=0), os_version=rd.OS93A)
    spec.streams[names[1]] = build_stream93a_type1(
        n_frames=20, n_bands=10, selector=1, seed=5)
    rs, _ = zipload.load_zip_data(romgen.RomBuilder(spec).build_zip())
    assert rs.check() == 1 and rs.os_version == rd.OS93A

    pcm, sched, _ = romplay.autoplay(rs, max_frames_per_track=60,
                                     return_tracer=True)
    dec = rd.ReferenceDecoder()
    dec.default_volume = 0x67
    dec.load_rom_set(rs)
    dec.soft_boot()
    events = {}
    for (tno, frame, _) in sched:
        def mk(track):
            def ev(d):
                d.clear_tracks()
                d.write_data_port((track >> 8) & 0xFF)
                d.write_data_port(track & 0xFF)
            return ev
        events[frame] = mk(tno)
    golden = []
    for f in range(pcm.size // 240):
        if f in events:
            events[f](dec)
        golden.extend(dec.next_samples(240))
    golden = np.array(golden, dtype=np.int16)
    assert np.abs(pcm).max() > 0
    assert np.array_equal(golden, pcm)


def test_control_plane_compression_roundtrip():
    """Serving control-plane compression (compress_controls /
    reconstruct_from_segments) is exact on real VM traces, the native
    tracer's in-trace segment emission (trace_segs) matches it
    segment-for-segment, the wire pack/unpack round-trips, and the
    decoded PCM through the compressed path is bit-identical."""
    import jax
    import jax.numpy as jnp
    from dcsexplorer_tpu.models import pipeline as pl
    from dcsexplorer_tpu.vm import native_tracer as nt

    rs = _rom_set()
    bank = romplay.build_rom_bank(rs)
    B, T, C = 3, 120, 6

    def events(b):
        ev = {}
        for f in (3 * b, 60):
            ev[f] = []
            for t in range(1, 4):
                ev[f] += [0x00, t]
        return ev

    rows, mixes, vols = [], [], []
    for b in range(B):
        tr = pl.ControlTracer()
        tr.load_rom_set(rs)
        tr.soft_boot()

        def mk(ev_bytes):
            def ev(d):
                for x in ev_bytes:
                    d.write_data_port(x)
            return ev
        tr.trace_frames(T, events={f: mk(bs)
                                   for f, bs in events(b).items()})
        r, m, v = pl.assemble_controls(tr, bank)
        rows.append(r[:, :C])
        mixes.append(m[:, :C])
        vols.append(v)
    rows = np.stack(rows)
    mixes = np.stack(mixes)
    vols = np.stack(vols)

    comp = romplay.compress_controls(rows, mixes)
    assert comp is not None
    # this trace is deliberately fade-heavy (each fade step changes the
    # mix multiplier -> one segment per step); steady-music serving
    # lanes compress to a handful of segments
    E = comp["f0"].shape[-1]
    assert E <= 128

    r2, m2 = romplay.reconstruct_from_segments(
        *[jnp.asarray(comp[k], jnp.int32)
          for k in ("f0", "base", "slope", "mixv")], T)
    assert np.array_equal(np.asarray(r2), rows)
    assert np.array_equal(np.asarray(m2), mixes)

    # the native tracer emits the SAME segments during the trace (no
    # dense arrays on the host at all)
    if nt.available():
        addr_tab, off_tab = nt.stream_row_table(rs, bank)
        for b in range(B):
            f0 = np.zeros((C, E), np.uint16)
            base = np.zeros((C, E), np.uint16)
            slope = np.zeros((C, E), np.uint8)
            mixv = np.zeros((C, E), np.uint16)
            vol = np.zeros(T, np.uint8)
            tr = nt.NativeControlTracer(rs)
            tr.soft_boot()
            ok = tr.trace_segs(T, addr_tab, off_tab, f0, base, slope,
                               mixv, vol, events(b))
            tr.close()
            assert ok
            assert np.array_equal(f0, comp["f0"][b])
            assert np.array_equal(base, comp["base"][b])
            assert np.array_equal(slope, comp["slope"][b])
            assert np.array_equal(mixv, comp["mixv"][b])
            assert np.array_equal(vol, vols[b].astype(np.uint8))

    # wire pack/unpack round-trips
    buf = romplay.pack_controls_wire(comp, vols)
    f0w, bw, sw, mw, vw = jax.jit(
        romplay.unpack_controls_wire, static_argnums=(1, 2, 3, 4))(
        jnp.asarray(buf), B, T, C, E)
    assert np.array_equal(np.asarray(f0w), comp["f0"].astype(np.int64))
    assert np.array_equal(np.asarray(bw), comp["base"].astype(np.int64))
    assert np.array_equal(np.asarray(sw), comp["slope"])
    assert np.array_equal(np.asarray(mw), comp["mixv"].astype(np.int64))
    assert np.array_equal(np.asarray(vw), vols.astype(np.uint8))

    # end-to-end: compressed-upload decode == dense-upload decode
    dec = bank.decode_fn()

    def dense_fn(ba, r, m, v):
        pcm, _ = jax.vmap(lambda a, b_, c: dec(ba, a, b_, c))(r, m, v)
        return pcm

    def comp_fn(ba, buf, v):
        f0, base, slope, mixv, _ = romplay.unpack_controls_wire(
            buf, B, T, C, E)
        r, m = romplay.reconstruct_from_segments(f0, base, slope, mixv, T)
        pcm, _ = jax.vmap(lambda a, b_, c: dec(ba, a, b_, c))(r, m, v)
        return pcm

    ba = bank.bank_args()
    want = np.asarray(jax.jit(dense_fn)(
        ba, jnp.asarray(rows, jnp.int32), jnp.asarray(mixes, jnp.int32),
        jnp.asarray(vols, jnp.int32)))
    got = np.asarray(jax.jit(comp_fn)(
        ba, jnp.asarray(buf), jnp.asarray(vols, jnp.int32)))
    assert np.array_equal(want, got)
