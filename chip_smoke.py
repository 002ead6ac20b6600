#!/usr/bin/env python
"""Smoke run of the main paths on one NVIDIA GPU at a real ROM set's size.

    python chip_smoke.py              # four phases on the first card
    python chip_smoke.py --four-cards # only the sharded paths, on four cards

Every input is generated from ``--seed`` out of ``assets/streams`` by
``compiler/romgen``; nothing is downloaded.  The ROM sets:

- ``rom94``   OS94, 6 voices, 8 x 1 MiB chips (U2-U9) filled with streams
- ``rom93b``  OS93b, 8 x 512 KiB chips filled with streams
- ``rom93a1`` OS93a with Type-1 streams, 8 x 512 KiB chips filled
- ``rom94s``  OS94, 6 voices, 4 x 1 MiB chips, trimmed to the session
              bank's 64Ki-row cap

Phases (all in this one process, so one JAX process holds the card; the
scalar references run in spawned workers that never start a JAX backend):

1. catalogue: cold sweep from ROM zip bytes (``FlatSweep`` for the 94
   family, ``catalogsweep.Flat93Sweep`` for 93b and 93a Type-1) plus
   ``romplay.autoplay`` on rom94; seeded whole streams are compared bit for
   bit with the scalar reference decoder.
2. serve: ``romplay.SessionServer`` over rom94s, more batches than its
   pipeline depth, seeded sessions of every batch compared with the scalar
   decoder fed the same port bytes.
3. cli: ``tools.explorer.main`` in-process with ``--autoplay`` and
   ``--validate`` on a small generated ROM.
4. encode: ``encode_files_device`` against the host ``encode_files`` on
   44.1 kHz clips (so the resampler runs); one stream decoded back through
   the device sweep and compared with the scalar reference.

Output: the card line (``nvidia-smi`` name and power limit, JAX version,
device kind, XLA_FLAGS), one JSON line per phase, and as the last line
``{"ok": true, "device": {...}}``.  Any mismatch or error exits non-zero
before that line; a platform other than ``gpu`` is refused.
"""

import argparse
import concurrent.futures as cf
import contextlib
import functools
import glob
import hashlib
import io
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STREAMS = os.path.join(HERE, "assets", "streams")
MIB = 1 << 20
SESSION_ROW_CAP = (1 << 16) - 1        # romplay.SessionServer's u16 row ids


# -- inputs -------------------------------------------------------------

def _assets(pattern):
    paths = sorted(glob.glob(os.path.join(STREAMS, pattern)))
    return [open(p, "rb").read() for p in paths]


def _n_frames(stream):
    return (stream[0] << 8) | stream[1]


def make_rom(os_version, assets, chip_size, n_chips, seed, n_voices=6,
             max_frames=None, max_streams=None):
    """ROM zip bytes holding as many streams as fit in ``n_chips`` chips.

    ``assets`` are cycled in a seeded order under distinct names; one
    type-1 track per stream plays it on voice ``k % n_voices``.  The stream
    count is the largest that romgen can lay out (and, with
    ``max_frames``, whose frames stay within it).  Returns (zip bytes,
    stream count)."""
    from dcsexplorer_tpu.compiler import romgen as g
    if max(len(a) for a in assets) > chip_size - 4096:
        raise ValueError("chips too small for the stream assets")
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(assets))
    levels = rng.integers(0x40, 0x78, size=4096)

    def spec(n):
        s = g.RomSpec(os_version=os_version, num_channels=n_voices,
                      chip_size=chip_size, max_chips=n_chips)
        s.tracks = [g.TrackSpec(0, steps=[g.op_end()])]
        for k in range(n):
            name = f"s{k:04d}"
            s.streams[name] = assets[order[k % len(assets)]]
            ch = k % n_voices
            s.tracks.append(g.TrackSpec(k + 1, channel=ch, steps=[
                g.op_mix(0, ch, int(levels[k % levels.size])),
                g.op_play(ch, name, repeat=0),
                g.op_wait_forever()]))
        return s

    def fits(n):
        if max_frames is not None and sum(
                _n_frames(assets[order[k % len(assets)]])
                for k in range(n)) > max_frames:
            return False
        try:
            g.RomBuilder(spec(n)).build()
        except MemoryError:
            return False
        return True

    lo, hi = 1, max_streams or 1 + n_chips * chip_size // min(
        len(a) for a in assets)
    assert fits(lo), "not even one stream fits"
    while lo < hi:                      # largest n that fits
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return g.RomBuilder(spec(lo)).build_zip(), lo


def rom_sets(seed, chip_94=MIB, chip_93=MIB // 2, n_chips=8,
             n_chips_session=4):
    """The four ROM sets.  The defaults are the full sizes; tests pass
    smaller chips and fewer of them."""
    from dcsexplorer_tpu.refdec import decoder as rd
    rom94, _ = make_rom(rd.OS94, _assets("*.dcs94"), chip_94, n_chips, seed)
    rom93b, _ = make_rom(rd.OS93B, _assets("*.dcs93b"), chip_93, n_chips,
                         seed + 1)
    rom93a1, _ = make_rom(rd.OS93A, _assets("*.dcs93a1"), chip_93, n_chips,
                          seed + 2)
    rom94s, _ = make_rom(rd.OS94, _assets("*.dcs94"), chip_94,
                         n_chips_session, seed + 3,
                         max_frames=SESSION_ROW_CAP - 1)
    return dict(rom94=rom94, rom93b=rom93b, rom93a1=rom93a1, rom94s=rom94s)


def load_rom(zip_bytes):
    from dcsexplorer_tpu.rom import zipload
    rs, _ = zipload.load_zip_data(zip_bytes)
    status = rs.check()
    if status != 1:
        raise RuntimeError(f"generated ROM fails its POST checks ({status})")
    return rs


def rom_streams(rs):
    """Every stream the ROM's tracks play, cut from the ROM images at the
    end its family's indexer finds (plus the 8-byte read-ahead margin)."""
    from dcsexplorer_tpu.ops import decode93, decode93a, prescan
    from dcsexplorer_tpu.refdec import decoder as rd
    from dcsexplorer_tpu.rom import tracks as rtracks
    out = []
    for linear in rtracks.list_streams(rs, rs.os_version):
        p = rs.make_pointer(linear)
        mem = p.mem.mem if isinstance(p.mem, rd.PaddedView) else p.mem
        if rs.os_version == rd.OS94:
            idx = prescan.prescan94(mem, p.pos)
        elif int(mem[p.pos + 2]) & 0x80 and rs.os_version == rd.OS93A:
            idx = decode93a.prescan93a(mem, p.pos)
        else:
            idx = decode93.prescan93(mem, p.pos)
        end = int(idx.end_bit[-1]) // 8 + 8 if idx.n_frames else p.pos + 18
        out.append(bytes(mem[p.pos:end]))
    return out


def session_events(rs, n_sessions, seed, n_voices=6):
    """Distinct six-voice sessions: one seeded track per voice, staggered
    starts and a seeded master volume (the serving bench's shape).  Each
    session is {frame: [port bytes]}."""
    from dcsexplorer_tpu.rom import tracks as rtracks
    by_voice = {}
    for t in range(1, rs.n_tracks):
        ti = rtracks.get_track_info(rs, rs.os_version, t)
        if ti is not None and ti.type == 1:
            by_voice.setdefault(ti.channel, []).append(t)
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_sessions):
        ev = {}
        vol = int(rng.integers(0x40, 0x100))
        ev[0] = [0x55, 0xAA, vol, vol ^ 0xFF]
        for v in sorted(by_voice)[:n_voices]:
            t = int(rng.choice(by_voice[v]))
            ev.setdefault((b * 7 + v * 3) % 40, []).extend([t >> 8, t & 0xFF])
        out.append(ev)
    return out


def encode_jobs(n_clips, seconds, rate, seed):
    """Seeded chord/tremolo/noise clips as int16 PCM at ``rate``."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    jobs = []
    for _ in range(n_clips):
        f0 = rng.uniform(110.0, 880.0, size=4)
        x = sum(0.2 * np.sin(2 * np.pi * f * t) for f in f0)
        x *= 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t)
        x += 0.01 * rng.standard_normal(t.size)
        jobs.append(((x / np.abs(x).max() * 0.8 * 32767).astype(np.int16),
                     rate))
    return jobs


# -- scalar references (run in spawned workers: numpy only, no JAX) -----

def _backend_started():
    """Whether this process has started a JAX backend."""
    if "jax" not in sys.modules:
        return False
    from jax._src import xla_bridge
    return xla_bridge.backends_are_initialized()


def _scalar(dec, events, n_frames):
    out = np.empty(n_frames * 240, np.int16)
    for f in range(n_frames):
        for b in events.get(f, ()):
            if b is None:
                dec.clear_tracks()
            else:
                dec.write_data_port(b)
        out[f * 240:(f + 1) * 240] = dec.next_samples(240)
    return out


def ref_standalone(stream, os_version, volume):
    """One stream played alone at mixing level 0x64 (the sweeps' contract)."""
    from dcsexplorer_tpu.refdec import registry
    dec = registry.create("native")
    dec.default_volume = volume
    dec.init_standalone(os_version)
    dec.soft_boot()
    dec.load_audio_stream(0, bytes(stream), mixing_level=0x64)
    pcm = np.asarray(dec.next_samples(_n_frames(stream) * 240), np.int16)
    return pcm, _backend_started()


def ref_session(zip_bytes, events, n_frames, volume):
    """A ROM session fed port bytes ({frame: [bytes]}; None clears the
    tracks first, as autoplay does)."""
    from dcsexplorer_tpu.refdec import registry
    dec = registry.create("native")
    dec.default_volume = volume
    dec.load_rom_set(load_rom(zip_bytes))
    dec.soft_boot()
    return _scalar(dec, events, n_frames), _backend_started()


def probe_encode_worker(rate):
    """The host encoder's per-file work in a spawned worker; reports
    whether it started a JAX backend (it must not: the parent holds the
    card)."""
    from dcsexplorer_tpu.encoder import encoder as enc
    pcm, _ = encode_jobs(1, 0.1, rate, 0)[0]
    enc.encode_pcm(pcm, sample_rate=rate)
    return _backend_started()


def reference_pool(workers):
    return cf.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


def _check_ref(name, got, fut):
    want, started = fut.result()
    if started:
        raise RuntimeError(f"{name}: a reference worker started JAX")
    if want.shape != got.shape or not np.array_equal(want, got):
        bad = np.nonzero(want != got)[0] if want.shape == got.shape else []
        raise AssertionError(
            f"{name}: device PCM differs from the scalar reference "
            f"({len(bad)} samples, shapes {got.shape} vs {want.shape})")
    return int(got.size // 240)


# -- device helpers -----------------------------------------------------

def _i16(words):
    w = np.asarray(words).reshape(-1)
    return (((w & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int16)


def _memory(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def _aot(fn, *args):
    """Lower and compile ``fn`` for ``args``: (compiled, seconds, memory)."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0, _memory(compiled)


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _native():
    """True when the native runtime loaded, else why it did not (the
    host paths then fall back to the Python indexer and tracer)."""
    from dcsexplorer_tpu import native
    return native.get_lib() is not None or native.build_error


def _sha(arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def dot_lowering(hlo_text):
    """How the dots of an optimized HLO module were lowered: GEMM kernels
    (cuBLAS calls, XLA's Triton GEMM fusions) against dots left inside
    plain loop fusions."""
    import re
    count = lambda pat: len(re.findall(pat, hlo_text))
    return dict(cublas=count(r'custom_call_target="__cublas'),
                triton_gemm=count(r"%gemm_fusion[\w.]* = "),
                loop_dot=count(r"%wrapped_dot[\w.]* = "))


# -- phases -------------------------------------------------------------

def _sweep_family(name, rs, t1):
    """Index, trace and pack one family's catalogue, then compile and run
    its packed device pipeline.  Returns (phase row, streams, int16 PCM)."""
    import jax
    from dcsexplorer_tpu.models import catalogsweep, flatsweep
    from dcsexplorer_tpu.refdec import decoder as rd
    t0 = time.perf_counter()
    streams = rom_streams(rs)
    if rs.os_version == rd.OS94:
        sw = flatsweep.FlatSweep(streams).pack()
        ca = sw.compact_host_arrays()
        fn = functools.partial(
            lambda a, n_steps: flatsweep.flat_pipeline_packed(
                a["pool_u8"], a["sid"], a["start_bit"], a["bt_u8"],
                a["mix_u16"], a["vol_u8"], a["hdr_tab"], a["fmt_tab"],
                a["sub_tab"], n_steps), n_steps=ca.pop("n_steps"))
    else:
        sw = catalogsweep.Flat93Sweep(streams, t1=t1)
        ca = sw.compact_host_arrays()
        fn = functools.partial(catalogsweep.run_flat93_pcm, t1=t1,
                               nwords=sw.nwords)
    host_s = time.perf_counter() - t0
    compiled, compile_s, mem = _aot(fn, ca)
    t0 = time.perf_counter()
    pcm = jax.block_until_ready(compiled(ca))
    run_s = time.perf_counter() - t0
    pcm = _i16(pcm)
    frames = sum(_n_frames(s) for s in streams)
    if frames != sw.n_frames_total or pcm.size != frames * 240:
        raise AssertionError(f"{name}: frame count mismatch")
    row = dict(streams=len(streams), frames=frames,
               audio_s=frames * 240 / 31250, host_s=host_s,
               compile_s=compile_s, run_s=run_s, memory=mem,
               pcm_sha=_sha([pcm]))
    return row, streams, pcm


def phase_catalogue(roms, compare_frames, seed, pool):
    """Cold catalogue sweep of rom94/rom93b/rom93a1 plus autoplay(rom94)."""
    from dcsexplorer_tpu.models import romplay
    from dcsexplorer_tpu.refdec import decoder as rd
    rng = np.random.default_rng(seed)
    families = {}
    checks = []
    for name, os_v, t1, vol in (("rom94", rd.OS94, False, 0x67),
                                ("rom93b", rd.OS93B, False, 255),
                                ("rom93a1", rd.OS93A, True, 255)):
        rs = load_rom(roms[name])
        if rs.os_version != os_v:
            raise AssertionError(f"{name}: detected OS {rs.os_version}")
        row, streams, pcm = _sweep_family(name, rs, t1)
        starts = np.cumsum([0] + [_n_frames(s) for s in streams])
        picked = 0
        for k in rng.permutation(len(streams)):
            if picked >= compare_frames:
                break
            seg = pcm[starts[k] * 240:starts[k + 1] * 240]
            checks.append((f"{name} stream {k}", seg, pool.submit(
                ref_standalone, streams[k], os_v, vol)))
            picked += _n_frames(streams[k])
        row["compared_frames"] = picked
        families[name] = row

    # the library's autoplay sweep over the whole of rom94
    rs = load_rom(roms["rom94"])
    t0 = time.perf_counter()
    pcm, schedule = romplay.autoplay(rs)
    auto_s = time.perf_counter() - t0
    n = next((f + d for (_, f, d) in schedule if f + d >= compare_frames),
             pcm.size // 240)
    events = {f: [None, t >> 8, t & 0xFF] for (t, f, _) in schedule
              if f < n}
    checks.append(("autoplay prefix", pcm[:n * 240],
                   pool.submit(ref_session, roms["rom94"], events, n, 0x67)))
    compared = {}
    for name, got, fut in checks:
        key = name.split()[0]
        compared[key] = compared.get(key, 0) + _check_ref(name, got, fut)
    return dict(
        phase="catalogue", families=families,
        autoplay=dict(tracks=len(schedule), frames=pcm.size // 240,
                      seconds=auto_s, compared_frames=compared["autoplay"],
                      pcm_sha=_sha([pcm])),
        catalogue_sha=_sha([bytes.fromhex(f["pcm_sha"])
                            for f in families.values()]),
        native_runtime=_native(), peak_bytes_in_use=_peak_bytes(),
        compared_frames=compared, ok=True)


def phase_serve(zip_bytes, n_sessions, n_frames, n_batches, check_per_batch,
                seed, pool, depth=3):
    """SessionServer over rom94s: every batch yielded in order, seeded
    sessions of each batch equal to the scalar decoder."""
    from dcsexplorer_tpu.models import romplay
    rs = load_rom(zip_bytes)
    batches = [session_events(rs, n_sessions, seed + k)
               for k in range(n_batches)]
    t0 = time.perf_counter()
    srv = romplay.SessionServer(rs, n_sessions=n_sessions, n_frames=n_frames,
                                depth=depth)
    try:
        bank_s = time.perf_counter() - t0
        wire, e = srv._prepare(batches[0])
        _, compile_s, mem = _aot(srv._program(e), srv.bank.bank_args(), wire)
        t0 = time.perf_counter()
        first = srv.serve_one(batches[0])
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = []
        for out in srv.serve(batches):
            outs.append(out)
        run_s = time.perf_counter() - t0
    finally:
        srv.close()
    if len(outs) != n_batches:
        raise AssertionError(f"served {len(outs)} of {n_batches} batches")
    if not np.array_equal(first, outs[0]):
        raise AssertionError("batch 0 differs between two serves")
    rng = np.random.default_rng(seed)
    checks = []
    for k, out in enumerate(outs):
        if out.shape != (n_sessions, n_frames * 240):
            raise AssertionError(f"batch {k}: shape {out.shape}")
        for b in rng.choice(n_sessions, check_per_batch, replace=False):
            checks.append((f"batch {k} session {b}", out[b], pool.submit(
                ref_session, zip_bytes, batches[k][b], n_frames, 0x67)))
    compared = sum(_check_ref(*c) for c in checks)
    audio_s = n_batches * n_sessions * n_frames * 240 / 31250
    return dict(phase="serve", sessions=n_sessions, frames=n_frames,
                batches=n_batches, depth=depth,
                bank_rows=srv.bank.total_rows(),
                bank_s=bank_s, compile_s=compile_s, warm_s=warm_s,
                run_s=run_s, audio_s=audio_s, memory=mem,
                compared_sessions=len(checks), compared_frames=compared,
                native_runtime=_native(), peak_bytes_in_use=_peak_bytes(),
                ok=True)


def phase_cli(zip_bytes, max_track_frames):
    """The explorer CLI in-process: --autoplay to a WAV, then --validate."""
    from dcsexplorer_tpu.tools import explorer
    with tempfile.TemporaryDirectory() as d:
        rom = os.path.join(d, "smoke.zip")
        wav = os.path.join(d, "autoplay.wav")
        with open(rom, "wb") as f:
            f.write(zip_bytes)
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc_auto = explorer.main([rom, "--autoplay", wav, "--terse",
                                     "--max-track-frames",
                                     str(max_track_frames)])
            auto_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rc_val = explorer.main([rom, "--validate", "--max-track-frames",
                                    str(max_track_frames)])
        val_s = time.perf_counter() - t0
        wav_bytes = os.path.getsize(wav) if os.path.exists(wav) else 0
    text = log.getvalue()
    if rc_auto != 0 or wav_bytes <= 44:
        raise AssertionError(f"--autoplay failed (rc {rc_auto}):\n{text}")
    if rc_val != 0 or "Validation Succeeded" not in text:
        raise AssertionError(f"--validate failed (rc {rc_val}):\n{text}")
    compared = next((ln.split(":", 1)[1].strip() for ln in text.splitlines()
                     if ln.startswith("Samples compared")), None)
    return dict(phase="cli", autoplay_s=auto_s, validate_s=val_s,
                wav_bytes=wav_bytes, validate=compared,
                native_runtime=_native(), peak_bytes_in_use=_peak_bytes(),
                ok=True)


def phase_encode(n_clips, seconds, rate, seed, pool):
    """encode_files_device against encode_files, byte for byte; one stream
    decoded back through the device sweep against the scalar decoder."""
    from jax import ShapeDtypeStruct as SDS
    from dcsexplorer_tpu.encoder import device94
    from dcsexplorer_tpu.encoder import encoder as enc
    from dcsexplorer_tpu.models import flatsweep
    from dcsexplorer_tpu.refdec import decoder as rd
    jobs = encode_jobs(n_clips, seconds, rate, seed)
    probe = pool.submit(probe_encode_worker, rate)
    t0 = time.perf_counter()
    host = enc.encode_files(jobs)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = enc.encode_files_device(jobs)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev2 = enc.encode_files_device(jobs)
    run_s = time.perf_counter() - t0
    for i, (h, d, d2) in enumerate(zip(host, dev, dev2)):
        if h != d or d != d2:
            raise AssertionError(f"clip {i}: device stream differs from host")
    if probe.result():
        raise RuntimeError("an encode_files worker started a JAX backend")

    # the device program's memory and how its int8 dots lowered
    params = enc.CompressionParams()
    slots = device94._select_formats(params)
    fmax = device94._bucket(max(nf for _, nf in dev))
    b, k = min(16, n_clips), len(slots)
    i32 = np.int32
    compiled = device94._compiled(fmax, slots, True).lower(
        SDS((b, fmax * 240 + 240), np.int16), SDS((b,), i32), SDS((), i32),
        SDS((b, 16), bool), SDS((16,), i32), SDS((16,), i32),
        SDS((16,), i32), SDS((b, k, 16), np.uint8), SDS((b, k), bool)
    ).compile()

    stream = dev[int(np.random.default_rng(seed).integers(n_clips))][0]
    want = pool.submit(ref_standalone, stream, rd.OS94, 0x67)
    sw = flatsweep.FlatSweep([stream]).pack()
    pcm = flatsweep.run_flat(sw)
    compared = _check_ref("encoded stream", pcm, want)
    audio_s = sum(len(p) / r for p, r in jobs)
    return dict(phase="encode", clips=n_clips, rate=rate, audio_s=audio_s,
                host_s=host_s, device_first_s=first_s, device_run_s=run_s,
                compile_s=max(first_s - run_s, 0.0),
                stream_bytes=sum(len(s) for s, _ in dev),
                memory=_memory(compiled),
                int8_dots=dot_lowering(compiled.as_text()),
                byte_identical=True, compared_frames=compared,
                workers_started_jax=False, native_runtime=_native(),
                peak_bytes_in_use=_peak_bytes(), ok=True)


def _spread(name, arr, n):
    devs = {s.device for s in arr.addressable_shards}
    if len(arr.sharding.device_set) != n or len(devs) != n:
        raise AssertionError(f"{name}: result on {len(devs)} devices")


def four_flat_sweep(rom94, devices):
    """rom94's whole catalogue on the 1-D flat-frame mesh."""
    import jax
    from dcsexplorer_tpu.models import flatsweep
    from dcsexplorer_tpu.ops import band_decode as bd
    from dcsexplorer_tpu.parallel import sweep
    sw = flatsweep.FlatSweep(rom_streams(load_rom(rom94))).pack()
    args = list(sw.args())
    args[0] = bd.window_quads(args[0])
    t0 = time.perf_counter()
    one = np.asarray(jax.jit(flatsweep.flat_pipeline, static_argnums=(10,))(
        *args))
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = jax.block_until_ready(sweep.sharded_flat_sweep(
        sweep.make_flat_mesh(devices), tuple(args)))
    four_s = time.perf_counter() - t0
    _spread("flat sweep", four, len(devices))
    if not np.array_equal(np.asarray(four), one):
        raise AssertionError("sharded flat sweep differs from one device")
    return dict(frames=sw.n_frames_total, one_card_s=one_s,
                four_card_s=four_s)


def four_sessions(rom94s, n_sessions, n_frames, seed, devices):
    """One batch of rom94s sessions, data parallel over the flat mesh,
    against SessionServer on one device."""
    import jax
    import jax.numpy as jnp
    from dcsexplorer_tpu.models import romplay
    from dcsexplorer_tpu.parallel import sweep
    rs = load_rom(rom94s)
    batch = session_events(rs, n_sessions, seed)
    with romplay.SessionServer(rs, n_sessions=n_sessions,
                               n_frames=n_frames) as srv:
        t0 = time.perf_counter()
        one = srv.serve_one(batch)
        one_s = time.perf_counter() - t0
        wire, e = srv._prepare(batch)
        f0, base, slope, mixv, vol = romplay.unpack_controls_wire(
            jnp.asarray(wire), n_sessions, n_frames, srv.n_ch, e)
        rows, mix = romplay.reconstruct_from_segments(f0, base, slope, mixv,
                                                      n_frames)
        t0 = time.perf_counter()
        four = jax.block_until_ready(sweep.sharded_sessions(
            sweep.make_flat_mesh(devices), srv.bank, rows, mix,
            vol.astype(jnp.int32)))
        four_s = time.perf_counter() - t0
    _spread("sessions", four, len(devices))
    if not np.array_equal(_i16(four).reshape(one.shape), one):
        raise AssertionError("sharded sessions differ from one device")
    return dict(sessions=n_sessions, frames=n_frames, one_card_s=one_s,
                four_card_s=four_s)


def four_tracks_frames(devices):
    """The padded [streams, frames] model on the 2-D (tracks, frames)
    mesh, at a small size."""
    import jax
    import jax.numpy as jnp
    from dcsexplorer_tpu.models import batched
    from dcsexplorer_tpu.parallel import sweep
    short = [s for s in _assets("*.dcs94") if _n_frames(s) < 300]
    args = list(batched.SweepInputs(short).args())
    pad = (-args[1].shape[1]) % 2
    for k in (1, 5, 6, 7, 8):
        widths = [(0, 0)] * args[k].ndim
        widths[1] = (0, pad)
        args[k] = jnp.pad(args[k], widths)
    args = tuple(args)
    one = np.asarray(jax.jit(batched.batch_decode,
                             static_argnums=(3, 4, 9))(*args))
    four = sweep.sharded_sweep(sweep.make_mesh(devices, frame_shards=2), args)
    _spread("2-D sweep", four, len(devices))
    if not np.array_equal(np.asarray(four), one):
        raise AssertionError("2-D sharded sweep differs from one device")
    return dict(streams=len(short), frames=int(args[1].shape[1]))


def phase_four_cards(rom94, rom94s, n_sessions, n_frames, seed, devices):
    """The sharded paths on four devices, each compared bit for bit with
    the one-device result computed in the same process on device 0."""
    if len(devices) < 4:
        raise RuntimeError(f"four devices needed, found {len(devices)}")
    devices = devices[:4]
    return dict(phase="four_cards", devices=len(devices),
                flat_sweep=four_flat_sweep(rom94, devices),
                sessions=four_sessions(rom94s, n_sessions, n_frames, seed,
                                       devices),
                tracks_frames=four_tracks_frames(devices),
                peak_bytes_in_use=_peak_bytes(), ok=True)


# -- entry point --------------------------------------------------------

def card_query():
    """``nvidia-smi`` name and power limit of every card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return "; ".join(lines) or None


def _emit(row):
    print(json.dumps(row, default=float), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    card = card_query()                 # before JAX starts
    import jax
    import dcsexplorer_tpu  # noqa: F401  (fails outside the repository)
    from dcsexplorer_tpu.utils import compile_cache
    compile_cache.enable()
    dev = jax.devices()
    if dev[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev[0].platform}",
              file=sys.stderr)
        return 1
    if card is None:
        print("chip_smoke: nvidia-smi found no card", file=sys.stderr)
        return 1
    flags = os.environ.get("XLA_FLAGS", "")
    print(f"card: {card} | jax {jax.__version__} | device_kind "
          f"{dev[0].device_kind} | XLA_FLAGS={flags!r}", flush=True)

    t0 = time.perf_counter()
    roms = rom_sets(args.seed)
    _emit(dict(phase="setup", seconds=time.perf_counter() - t0,
               rom_bytes={k: len(v) for k, v in roms.items()},
               native_runtime=_native()))
    if args.four_cards:
        _emit(phase_four_cards(roms["rom94"], roms["rom94s"], 256, 1000,
                               args.seed, dev))
    else:
        from dcsexplorer_tpu.refdec import decoder as rd
        small, _ = make_rom(rd.OS94, _assets("*.dcs94")[:2], 512 * 1024, 1,
                            args.seed, max_streams=2)
        with reference_pool(min(16, os.cpu_count() or 1)) as pool:
            _emit(phase_catalogue(roms, 2000, args.seed, pool))
            _emit(phase_serve(roms["rom94s"], 256, 1000, 5, 2, args.seed,
                              pool))
            _emit(phase_cli(small, 400))
            _emit(phase_encode(64, 10.0, 44100, args.seed, pool))
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
