#!/usr/bin/env python
"""Benchmark: batched DCS decode throughput (×realtime per chip).

Configs (BASELINE.md #2/#3 realizations, all full device pipelines):

- flat94_music  — HEADLINE: the flat catalog sweep (Huffman symbol decode →
                  dequant/scale → inverse transform → overlap resolve) over
                  the dense music corpus (assets/streams/music_*.dcs94 —
                  realistic symbol density).
- flat94        — the same sweep over the legacy four-tone corpus, kept
                  for cross-round comparability.
- flat94_e2e    — the COLD end-to-end sweep: per-entry native indexing +
                  native VM trace + pack + upload + device sweep + PCM
                  checksum, nothing cached between entries/iterations.
- catalog_e2e   — the COLD end-to-end sweep over a MIXED all-family
                  catalog (94 + 93b + 93a-T1), each family's device
                  decode overlapping the next family's upload — the
                  test-all.bat integration shape; per-family host-stage
                  breakdown in stats.
- dec93b        — the 1993-format device kernel batched over music
                  streams (DEVICE STAGE ONLY — cold e2e is catalog_e2e).
- dec93a_t1     — the OS93a Type-1 (Judge Dredd) device kernel batched
                  (DEVICE STAGE ONLY).
- session6      — a batch of DISTINCT six-voice sessions (staggered
                  starts, per-session volumes) through the ROM-session
                  pipeline, timed END-TO-END: native runtime VM trace +
                  control assembly + device decode/mix/transform + PCM
                  checksum fetch (BASELINE #2 serving shape).
- enc94         — the host-native batched encoder (BASELINE #4): BLAS
                  analysis + the integer-canonical C++ format search,
                  end-to-end PCM → stream bytes across the worker pool.
- enc94_dev     — the same work on the chip: the whole format search as
                  one jitted device program; only the winner's per-frame
                  decisions return and the host re-derives the emission.
                  Byte-identical to enc94; end-to-end timed.
- enc93         — the 1993-family batched encoder: numpy analysis + the
                  native full-stream search/emission, both Type 0 and
                  Type 1 searched per file.

``vs_baseline`` compares the headline against the reference's native-
decoder floor of ~20× realtime on one CPU core (BASELINE.md).

Prints ONE JSON line; per-config numbers ride in the "configs" field, and
the line names the device it ran on (platform, device kind, device count,
the card's power limit).  It refuses to run unless the first device is a
GPU, or the CPU was asked for explicitly with JAX_PLATFORMS=cpu.
Env: DCS_BENCH_COPIES / DCS_BENCH_ITERS / DCS_BENCH_CONFIGS=a,b (subset).
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STREAMS = os.path.join(HERE, "assets", "streams")
LEGACY = ("sine_mix_1s", "noise_sweep", "tone_low", "chirpy")


def _read(names):
    out = []
    for n in names:
        with open(os.path.join(STREAMS, n), "rb") as f:
            out.append(f.read())
    return out


def _stats(times, audio_s=None):
    """Spread statistics over repeated timed runs (ms, plus ×realtime
    derived from the mean when audio_s is given)."""
    ts = sorted(times)
    n = len(ts)
    q = lambda p: ts[min(n - 1, int(p * n))]
    out = {"n": n,
           "mean_ms": round(sum(ts) / n * 1e3, 2),
           "min_ms": round(ts[0] * 1e3, 2),
           "p50_ms": round(q(0.50) * 1e3, 2),
           "p95_ms": round(q(0.95) * 1e3, 2),
           "max_ms": round(ts[-1] * 1e3, 2)}
    if audio_s is not None:
        out["x_mean"] = round(audio_s / (sum(ts) / n), 1)
        out["x_best"] = round(audio_s / ts[0], 1)
    return out


def _timeit(fn, args, iters):
    import jax
    jax.block_until_ready(fn(*args))      # compile + warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / iters


def bench_flat94(streams, copies, iters, shard=True):
    import jax
    import jax.numpy as jnp
    from dcsexplorer_tpu.models import flatsweep
    from dcsexplorer_tpu.ops import band_decode as bd

    catalog = streams * copies
    sweep_in = flatsweep.FlatSweep(catalog).pack()
    args = list(sweep_in.args())
    args[0] = bd.window_quads(args[0])

    def sweep(*a):
        pcm = flatsweep.flat_pipeline(*a)
        return jnp.sum(pcm & 0xFF, dtype=jnp.int32)

    devs = jax.devices()
    n_dev = len(devs) if shard else 1
    if n_dev > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from dcsexplorer_tpu.parallel import sweep as psweep
        mesh = psweep.make_flat_mesh(devs)
        args = list(psweep.pad_flat(tuple(args), n_dev))
        fn = jax.jit(sweep, static_argnums=(10,),
                     in_shardings=psweep.flat_shardings(mesh),
                     out_shardings=NamedSharding(mesh, P()))
    else:
        fn = jax.jit(sweep, static_argnums=(10,))
    dt = _timeit(fn, args, iters)
    return sweep_in.audio_samples / 31250.0 / dt / n_dev


def _bench_93_family(streams, is_t1, copies, iters):
    """Batch DISTINCT streams (cycled to ``copies`` elements): every batch
    element carries its own bitstream pool and prescan index, so symbol
    content, codebook mix and chain state vary across the batch — no
    broadcast replication."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from dcsexplorer_tpu.models.pipeline import ControlTracer
    from dcsexplorer_tpu.ops import band_decode as bd
    from dcsexplorer_tpu.ops import decode93, decode93a, transform as tf
    from dcsexplorer_tpu.refdec.decoder import OS93A, OS93B

    mod = decode93a if is_t1 else decode93
    per = []
    idxs = [(decode93a.prescan93a(s, 0) if is_t1
             else decode93.prescan93(s, 0)) for s in streams]
    nwords = max(mod.window_words_needed(i) for i in idxs)
    # heterogeneous frame counts: every element pads to the batch max
    # with index zeros (kind K_NONE / bits 0 — decoded as silence);
    # audio accounting counts only the REAL frames
    f_max = max(i.n_frames for i in idxs)
    for stream, idx in zip(streams, idxs):
        n_frames = idx.n_frames

        tr = ControlTracer()
        tr.default_volume = 255
        tr.init_standalone(OS93A if is_t1 else OS93B)
        tr.soft_boot()
        tr.load_audio_stream(0, stream, mixing_level=0x64)
        tr.trace_frames(n_frames)
        mix = np.zeros(f_max, dtype=np.int32)
        for t, entries in enumerate(tr.trace_entries):
            for (c, _, fidx, m) in entries:
                if c == 0 and fidx == t:
                    mix[t] = m
        vol = np.zeros(f_max, dtype=np.int32)
        vol[:n_frames] = np.asarray(tr.trace_vol_shift, dtype=np.int32)
        pool = np.frombuffer(bytes(stream) + b"\xff" * 8,
                             dtype=np.uint8).astype(np.int32)
        arrs = mod.index_arrays(idx)
        arrs = {k: jnp.pad(v, [(0, f_max - n_frames)]
                           + [(0, 0)] * (v.ndim - 1))
                for k, v in arrs.items()}
        per.append((bd.window_rows(jnp.asarray(pool), nwords),
                    arrs, jnp.asarray(mix), jnp.asarray(vol), n_frames))

    # cycle the distinct streams across the batch; the batch holds one
    # SHARED stack of the distinct pools (padded rectangular) and each
    # element selects its pool by index — per-element content without
    # replicating pool memory
    wmax = max(p[0].shape[0] for p in per)
    def padw(wd):
        return jnp.pad(wd, ((0, wmax - wd.shape[0]), (0, 0)))
    pools = jnp.stack([padw(p[0]) for p in per])   # [S, W, NW]
    pid = jnp.asarray([k % len(per) for k in range(copies)], jnp.int32)
    sel = [per[k % len(per)] for k in range(copies)]
    arrB = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[1] for p in sel])
    mixB = jnp.stack([p[2] for p in sel])
    volB = jnp.stack([p[3] for p in sel])
    true_frames = sum(p[4] for p in sel)

    def one(pools, pi, arrs, mixv, volv):
        ww = pools[pi]
        fb = mod.decode93a_frames(ww, arrs, mixv) if is_t1 else \
            mod.decode93_frames(ww, arrs, mixv)
        raw = tf.transform93_raw(fb, volv)
        pcm, _ = tf.overlap_resolve93(raw, jnp.zeros(16, jnp.int32))
        return pcm

    def batch(pools, pid, arrs, mixv, volv):
        pcm = jax.vmap(one, in_axes=(None, 0, 0, 0, 0))(
            pools, pid, arrs, mixv, volv)
        return jnp.sum(pcm & 0xFF, dtype=jnp.int32)

    fn = jax.jit(batch)
    dt = _timeit(fn, (pools, pid, arrB, mixB, volB), iters)
    return true_frames * 240 / 31250.0 / dt


def bench_flat94_e2e(iters, collect=None):
    """End-to-end COLD catalog sweep (the decode contract starts at ROM
    bytes, DCSDecoder.cpp:1579-1690): for EVERY catalog entry — native
    stream indexing (frame boundaries, band-type chains), native runtime
    VM trace (mix/volume), vectorized control pack — then upload, ONE
    device sweep dispatch, and the PCM checksum fetch.  Nothing is shared
    or cached between entries or iterations.

    The catalog ships in the transfer-compact layout (uint8 pool, uint8
    band types, per-stream header table; flatsweep.flat_pipeline_packed
    derives the rest on device) and the upload of chunk k overlaps the
    host indexing/packing of chunk k+1 via an uploader thread.  One fused
    program then sweeps all chunks in a single dispatch, and one scalar
    checksum fetch syncs it."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    import numpy as np
    from dcsexplorer_tpu.models import flatsweep

    streams = _read(["music_a.dcs94", "music_b.dcs94"]
                    + [f"{n}.dcs94" for n in LEGACY])
    copies = int(os.environ.get("DCS_BENCH_E2E_COPIES", "24"))
    n_chunks = int(os.environ.get("DCS_BENCH_E2E_CHUNKS", "4"))
    n_chunks = min(n_chunks, copies)
    per = copies // n_chunks
    chunks = [streams * per for _ in range(n_chunks - 1)]
    chunks.append(streams * (copies - per * (n_chunks - 1)))

    def sweep_chunks(chunk_args, n_steps):
        """Concatenate the chunks IN-PROGRAM (pool byte offsets and
        stream-id offsets are static — they come from shapes), then run
        ONE flat pipeline instance: chunked upload, single compile."""
        pool = jnp.concatenate([a["pool_u8"] for a in chunk_args])
        boff = np.cumsum([0] + [a["pool_u8"].shape[0]
                                for a in chunk_args[:-1]])
        soff = np.cumsum([0] + [a["hdr_tab"].shape[0]
                                for a in chunk_args[:-1]])
        cat = lambda k: jnp.concatenate([a[k] for a in chunk_args])
        sid = jnp.concatenate([
            a["sid"].astype(jnp.int32) + jnp.int32(s)
            for a, s in zip(chunk_args, soff)])
        start_bit = jnp.concatenate([
            a["start_bit"] + jnp.int32(b * 8)
            for a, b in zip(chunk_args, boff)])
        pcm = flatsweep.flat_pipeline_packed(
            pool, sid, start_bit, cat("bt_u8"), cat("mix_u16"),
            cat("vol_u8"), cat("hdr_tab"), cat("fmt_tab"), cat("sub_tab"),
            n_steps)
        return jnp.sum(pcm & 0xFF, dtype=jnp.int32)

    fn = jax.jit(sweep_chunks, static_argnums=(1,))
    ex = ThreadPoolExecutor(1)

    def pack(cat):
        sw = flatsweep.FlatSweep(cat)         # index + trace, per entry
        sw.pack()
        ca = sw.compact_host_arrays()
        ca.pop("n_steps")
        return ca, sw.audio_samples, sw.n_steps

    def upload(ca):
        return {k: jax.device_put(v) for k, v in ca.items()}

    def cold():
        """One cold iteration: pack chunk k+1 on this thread while the
        uploader thread uploads chunk k; then one dispatch + one checksum
        fetch."""
        audio = 0
        args = []
        up = None
        n_steps = 8
        for cat in chunks:
            ca, a, ns = pack(cat)
            n_steps = max(n_steps, ns)
            if up is not None:
                args.append(up.result())
            up = ex.submit(upload, ca)
            audio += a
        args.append(up.result())
        return int(fn(args, n_steps)), audio

    chk, audio_samples = cold()               # compile, untimed
    times = []
    for _ in range(max(2, iters)):
        t0 = time.perf_counter()
        c2, _ = cold()
        times.append(time.perf_counter() - t0)
        assert c2 == chk
    ex.shutdown()
    if collect is not None:
        collect["flat94_e2e"] = _stats(times, audio_samples / 31250.0)
    return audio_samples / 31250.0 / (sum(times) / len(times))


def bench_catalog_e2e(iters, collect=None):
    """End-to-end COLD sweep over a MIXED all-family catalog — the
    test-all.bat integration shape (one run covering every format family,
    /root/reference/DCSDecoder/Tests/test-all.bat:27-76).  Per iteration,
    per family: native stream indexing + native VM trace + compact pack,
    nothing cached between entries or iterations.  The three families
    pipeline: while family k's arrays upload (uploader thread) the main
    thread packs family k+1, and each family DISPATCHES as soon as its
    upload lands — so its device decode overlaps the next family's
    upload.  Three checksum fetches at the end sync everything.

    Per-family host-stage ms, frames, and audio seconds ride in
    collect["catalog_e2e"]["families"]."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    from dcsexplorer_tpu.models import catalogsweep, flatsweep
    from dcsexplorer_tpu.models.catalogsweep import run_flat93_pcm

    s94 = _read(["music_a.dcs94", "music_b.dcs94"]
                + [f"{n}.dcs94" for n in LEGACY])
    s93 = _read(["music_a.dcs93b", "music_b.dcs93a"])
    s93a = _read(["dense_t1.dcs93a1", "dense_t1b.dcs93a1"])
    # the corpus skews 94/95-family like the reference's title list
    # (test-all.bat: most of the 29 titles are 1994+ hardware)
    cat94 = s94 * int(os.environ.get("DCS_BENCH_CAT94_COPIES", "24"))
    cat93 = s93 * int(os.environ.get("DCS_BENCH_CAT93_COPIES", "12"))
    cat93a = s93a * int(os.environ.get("DCS_BENCH_CAT93A_COPIES", "12"))

    def sweep94(a, n_steps):
        pcm = flatsweep.flat_pipeline_packed(
            a["pool_u8"], a["sid"], a["start_bit"], a["bt_u8"], a["mix_u16"],
            a["vol_u8"], a["hdr_tab"], a["fmt_tab"], a["sub_tab"], n_steps)
        return jnp.sum(pcm & 0xFF, dtype=jnp.int32)

    f94 = jax.jit(sweep94, static_argnums=(1,))
    f93 = jax.jit(lambda a, nw: jnp.sum(
        run_flat93_pcm(a, False, nw) & 0xFF, dtype=jnp.int32),
        static_argnums=(1,))
    f93a = jax.jit(lambda a, nw: jnp.sum(
        run_flat93_pcm(a, True, nw) & 0xFF, dtype=jnp.int32),
        static_argnums=(1,))
    fns = {"94": f94, "93b": f93, "93a1": f93a}
    ex = ThreadPoolExecutor(1)

    def pack94():
        sw = flatsweep.FlatSweep(cat94)
        sw.pack()
        ca = sw.compact_host_arrays()
        return ca, ca.pop("n_steps"), sw.audio_samples, sw.n_frames_total

    def pack93():
        sw = catalogsweep.Flat93Sweep(cat93, t1=False)
        return (sw.compact_host_arrays(), sw.nwords, sw.audio_samples,
                sw.n_frames_total)

    def pack93a():
        sw = catalogsweep.Flat93Sweep(cat93a, t1=True)
        return (sw.compact_host_arrays(), sw.nwords, sw.audio_samples,
                sw.n_frames_total)

    def upload(ca):
        return {k: jax.device_put(v) for k, v in ca.items()}

    fam_stats = {k: dict(host_ms=[], frames=0, audio_s=0.0)
                 for k in ("94", "93b", "93a1")}

    def cold():
        """One cold iteration: index+trace+pack each family (main thread)
        while the previous family's arrays upload (uploader thread) and
        the one before THAT decodes on device (async dispatch)."""
        audio = 0
        pend = []
        up = None
        for name, pk in (("94", pack94), ("93b", pack93),
                         ("93a1", pack93a)):
            t0 = time.perf_counter()
            ca, meta, a, nf = pk()
            fam_stats[name]["host_ms"].append(
                (time.perf_counter() - t0) * 1e3)
            fam_stats[name]["frames"] = nf
            fam_stats[name]["audio_s"] = round(a / 31250.0, 2)
            if up is not None:
                pname, pmeta, fut = up
                pend.append(fns[pname](fut.result(), pmeta))  # async
            up = (name, meta, ex.submit(upload, ca))
            audio += a
        pname, pmeta, fut = up
        pend.append(fns[pname](fut.result(), pmeta))
        chk = sum(int(p) for p in pend)
        return chk, audio

    chk, audio_samples = cold()               # compile, untimed
    times = []
    for _ in range(max(2, iters)):
        for s in fam_stats.values():
            s["host_ms"].clear()
        t0 = time.perf_counter()
        c2, _ = cold()
        times.append(time.perf_counter() - t0)
        assert c2 == chk
    ex.shutdown()
    if collect is not None:
        st = _stats(times, audio_samples / 31250.0)
        st["families"] = {
            k: dict(host_ms=round(sum(v["host_ms"]) / len(v["host_ms"]), 1),
                    frames=v["frames"], audio_s=v["audio_s"])
            for k, v in fam_stats.items()}
        collect["catalog_e2e"] = st
    return audio_samples / 31250.0 / (sum(times) / len(times))


def bench_session6(iters, collect=None):
    """A batch of B six-voice sessions through the ROM session pipeline,
    timed END-TO-END: the native runtime VM (vm/native_tracer.py — track
    byte-code, command queue, fades, volume) traces every session, the
    controls COMPRESS to the segment form (romplay.compress_controls —
    the dense [S,T,C] u16 rows/mix were the dominant wire bytes), the
    compact batch uploads, and the device reconstructs + decodes it in
    one dispatch.  Each session is DISTINCT — staggered track starts and
    a different master volume — the realistic "many cabinets, one chip"
    serving shape.

    Reports mean/min/p50/p95 per batch (collect["session6"]) plus a
    serving-tick latency probe: wall-clock for a full trace→upload→
    decode→fetch round trip of ONE 8-frame tick across all sessions
    (collect["session6_tick"]).
    """
    import numpy as np
    from dcsexplorer_tpu.compiler import romgen as g
    from dcsexplorer_tpu.models import romplay
    from dcsexplorer_tpu.refdec import decoder as rd
    from dcsexplorer_tpu.rom import zipload
    from dcsexplorer_tpu.vm import native_tracer as nt

    names = ["music_a.dcs94", "music_b.dcs94"] + [f"{n}.dcs94" for n in LEGACY]
    datas = _read(names)
    spec = g.RomSpec(os_version=rd.OS94, num_channels=6)
    spec.streams = {f"s{i}": d for i, d in enumerate(datas)}
    spec.tracks = [g.TrackSpec(0, steps=[g.op_end()])]
    for i in range(6):
        spec.tracks.append(g.TrackSpec(i + 1, channel=i, steps=[
            g.op_mix(0, i, 0x40 + 4 * i),
            g.op_play(i, f"s{i}", repeat=0),
            g.op_wait_forever(),
        ]))
    rs, _ = zipload.load_zip_data(g.RomBuilder(spec).build_zip())
    rs.check()

    n_frames = 1000
    n_sessions = int(os.environ.get("DCS_BENCH_SESSIONS", "320"))
    bank = romplay.build_rom_bank(rs)
    assert nt.available(), "native runtime required for the session bench"

    def session_events(b):
        events = {}
        for t in range(1, 7):
            events.setdefault((b * 7 + t * 3) % 40, []).extend([0x00, t])
        vol = 0x40 + (b % 64)
        events.setdefault(0, []).extend([0x55, 0xAA, vol, vol ^ 0xFF])
        return events

    import jax
    import jax.numpy as jnp

    dec = bank.decode_fn()
    assert bank.total_rows() < (1 << 16), "u16 row ids need a small bank"
    CH = 6                                 # six-voice sessions: 6 lanes

    # fixed segment-table width across batches: one compiled program
    SEG_E = int(os.environ.get("DCS_BENCH_SEG_E", "32"))

    def fn(ba, buf, S, T):
        f0, base, slope, mixv, v = romplay.unpack_controls_wire(
            buf, S, T, CH, SEG_E)
        r, m = romplay.reconstruct_from_segments(f0, base, slope, mixv, T)
        v = v.astype(jnp.int32)
        pcm, _ = jax.vmap(lambda a, b_, c: dec(ba, a, b_, c))(r, m, v)
        return jnp.sum(pcm & 0xFF, dtype=jnp.int32)

    jfn = jax.jit(fn, static_argnums=(2, 3))
    fn = lambda buf, T=None: jfn(bank.bank_args(), buf, n_sessions,
                                 n_frames if T is None else T)

    addr_tab, off_tab = nt.stream_row_table(rs, bank)

    # ONE tracer handle, reused across sessions and batches: the batch
    # trace (dcstr_trace_segs_batch) soft-boots it between sessions, so
    # per-session handles would only duplicate the ROM chip copies
    tracer = nt.NativeControlTracer(rs)

    def prepare(base, T=None):
        """Host half: ONE C call per batch — the native runtime VM
        traces all sessions with in-trace control-plane SEGMENT
        emission (trace_segs_batch) straight into the batch arrays.
        No dense [T,C] control arrays are ever built and no per-session
        Python loop runs; the wire carries only the segment parameter
        tables and the volume column, packed into ONE uint8 buffer (one
        transfer per batch)."""
        T = n_frames if T is None else T
        f0 = np.zeros((n_sessions, CH, SEG_E), np.uint16)
        seg_base = np.zeros((n_sessions, CH, SEG_E), np.uint16)
        slope = np.zeros((n_sessions, CH, SEG_E), np.uint8)
        mixv = np.zeros((n_sessions, CH, SEG_E), np.uint16)
        vol = np.zeros((n_sessions, T), np.uint8)
        ok = tracer.trace_segs_batch(
            T, addr_tab, off_tab, f0, seg_base, slope, mixv, vol,
            [session_events(base + b) for b in range(n_sessions)])
        assert ok, "trace exceeded the segment cap"
        return romplay.pack_controls_wire(
            dict(f0=f0, base=seg_base, slope=slope, mixv=mixv), vol)

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    def serve(n_batches, ex_prep, ex_updisp, times=None, depth=3):
        """Steady-state serving, four-stage software pipeline: a prep
        thread runs the batch VM trace (one GIL-releasing C call) for
        batch k+2, an upload thread uploads batch k+1 AND dispatches it
        as soon as its upload lands (both release the GIL, so they
        genuinely overlap), the device decodes batch k, and the main
        thread pays only the per-batch checksum fetch."""
        total = 0
        prep_q = deque()
        disp_q = deque()
        ts = []                       # fetch-completion timestamps
        n_prep = min(depth, n_batches)
        for k in range(n_prep):
            prep_q.append(ex_prep.submit(prepare, k * n_sessions))
        for k in range(n_batches):
            host_buf = prep_q.popleft().result()
            disp_q.append(ex_updisp.submit(
                lambda hb=host_buf: fn(jax.device_put(hb))))
            if n_prep < n_batches:
                prep_q.append(ex_prep.submit(prepare,
                                             n_prep * n_sessions))
                n_prep += 1
            if len(disp_q) >= depth:
                total += int(disp_q.popleft().result())
                ts.append(time.perf_counter())
        while disp_q:
            total += int(disp_q.popleft().result())
            ts.append(time.perf_counter())
        if times is not None:
            # steady-state per-batch gaps: the first completion lands
            # after the depth-deep pipeline FILL, so its gap measures
            # fill + one batch, not serving rate — standard steady-state
            # timing drops it and measures between completions
            times.extend(b - a for a, b in zip(ts, ts[1:]))
        return total, ts

    ex_prep = ThreadPoolExecutor(1)
    ex_updisp = ThreadPoolExecutor(1)

    serve(1, ex_prep, ex_updisp)          # compile + warm
    # one extra batch absorbs the pipeline fill: throughput and spread
    # are measured over the n_batches STEADY batches between the first
    # and last fetch completions
    n_batches = max(2, iters) + 1
    times = []
    _, ts = serve(n_batches, ex_prep, ex_updisp, times)
    dt = ts[-1] - ts[0]
    audio_s = (n_batches - 1) * n_sessions * n_frames * 240 / 31250.0
    if collect is not None:
        collect["session6"] = _stats(
            times, n_sessions * n_frames * 240 / 31250.0)
        # serving-tick latency: ONE 8-frame tick, full round trip
        # (trace -> compress -> upload -> decode -> checksum fetch)
        tick = []
        int(fn(jax.device_put(prepare(0, T=8)), T=8))  # compile the shape
        for i in range(10):
            t0t = time.perf_counter()
            int(fn(jax.device_put(prepare(i * n_sessions, T=8)), T=8))
            tick.append(time.perf_counter() - t0t)
        collect["session6_tick"] = _stats(tick)
        collect["session6_tick"]["frames_per_tick"] = 8
        collect["session6_tick"]["sessions"] = n_sessions
    ex_prep.shutdown()
    ex_updisp.shutdown()
    tracer.close()
    return audio_s / dt


def _enc_jobs(n_files, seconds=2.0):
    import numpy as np
    rate = 31250
    rng = np.random.default_rng(7)
    t = np.arange(int(rate * seconds)) / rate
    jobs = []
    for k in range(n_files):
        x = np.zeros_like(t)
        for f0 in (220.0, 277.2, 329.6, 440.0):
            x += 0.2 * np.sin(2 * np.pi * f0 * (1 + 0.01 * k) * t)
        x *= 0.5 + 0.5 * np.sin(2 * np.pi * (1.3 + 0.1 * k) * t)
        x += 0.01 * rng.standard_normal(t.size)
        pcm = x / np.abs(x).max() * 0.8
        jobs.append(((pcm * 32767).astype(np.int16), rate))
    return jobs, n_files * seconds


def bench_enc94(iters, collect=None):
    """Host-native batched encoder (BASELINE #4): numpy/BLAS analysis +
    the integer-canonical C++ format search per file.  End-to-end from
    int16 PCM to stream bytes, ×realtime across the worker pool.

    Reports the MEAN like the decode benches (x_best rides in stats)."""
    from dcsexplorer_tpu.encoder import encoder as enc

    n_files = int(os.environ.get("DCS_BENCH_ENC_FILES", "16"))
    jobs, audio_s = _enc_jobs(n_files)
    enc.encode_files(jobs)                # warm (table builds, lib load)
    times = []
    for _ in range(max(2, iters // 2)):
        t0 = time.perf_counter()
        out = enc.encode_files(jobs)
        times.append(time.perf_counter() - t0)
        assert all(nf > 0 for (_, nf) in out)
    if collect is not None:
        collect["enc94"] = _stats(times, audio_s)
    return audio_s / (sum(times) / len(times))


def bench_enc93(iters):
    """1993-family batched encoder: numpy analysis + the native full-stream
    search/emission (native/src/encoder93.cpp), searching both Type 0 and
    Type 1 per file.  End-to-end from int16 PCM to stream bytes across the
    worker pool (reference counterpart: DCSEncoder.cpp:2053-2476)."""
    from dcsexplorer_tpu.encoder import encoder as enc
    from dcsexplorer_tpu.refdec.decoder import OS93B

    n_files = int(os.environ.get("DCS_BENCH_ENC_FILES", "16"))
    jobs, audio_s = _enc_jobs(n_files)
    enc.encode_files(jobs, os_version=OS93B)      # warm
    times = []
    for _ in range(max(2, iters // 2)):
        t0 = time.perf_counter()
        out = enc.encode_files(jobs, os_version=OS93B)
        times.append(time.perf_counter() - t0)
        assert all(nf > 0 for (_, nf) in out)
    return audio_s / (sum(times) / len(times))


def bench_enc94_dev(iters):
    """On-device batched encoder (BASELINE #4): the full format-
    candidate search — decision tables, wrap refinement, band-type scan,
    exact per-format sizes, winner selection — runs as one jitted device
    program over the whole batch; only the winner's per-frame decisions
    (32 bytes/frame) come back, and the host re-derives the emission.
    End-to-end from int16 PCM to stream bytes, byte-identical to enc94."""
    from dcsexplorer_tpu.encoder import encoder as enc

    n_files = int(os.environ.get("DCS_BENCH_ENC_FILES_DEV", "64"))
    jobs, audio_s = _enc_jobs(n_files)
    enc.encode_files_device(jobs)         # compile, untimed
    times = []
    for _ in range(max(2, iters // 2)):
        t0 = time.perf_counter()
        out = enc.encode_files_device(jobs)
        times.append(time.perf_counter() - t0)
        assert all(nf > 0 for (_, nf) in out)
    return audio_s / (sum(times) / len(times))


def _device_fields():
    """The device this run measures: platform, kind, count and the card's
    power limit.  Exits unless it is a GPU or JAX_PLATFORMS=cpu asked for
    the CPU."""
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        card = []
    import jax
    from dcsexplorer_tpu.utils import compile_cache
    compile_cache.enable()
    dev = jax.devices()
    cpu_asked = os.environ.get("JAX_PLATFORMS", "") == "cpu"
    if dev[0].platform != "gpu" and not (cpu_asked
                                         and dev[0].platform == "cpu"):
        sys.exit(f"bench.py: needs a GPU (found {dev[0].platform}); set "
                 "JAX_PLATFORMS=cpu to run on the CPU")
    return {"platform": dev[0].platform, "device_kind": dev[0].device_kind,
            "device_count": len(dev),
            "card": "; ".join(c.strip() for c in card) or None}


def main():
    device = _device_fields()
    copies = int(os.environ.get("DCS_BENCH_COPIES", "288"))
    iters = int(os.environ.get("DCS_BENCH_ITERS", "5"))
    only = os.environ.get("DCS_BENCH_CONFIGS")
    only = set(only.split(",")) if only else None

    configs = {}
    stats = {}

    def want(name):
        return only is None or name in only

    if want("flat94_music"):
        music = _read(["music_a.dcs94", "music_b.dcs94"])
        configs["flat94_music"] = bench_flat94(
            music, max(2, copies // 2), iters)
    if want("flat94"):
        legacy = _read([f"{n}.dcs94" for n in LEGACY])
        configs["flat94"] = bench_flat94(legacy, copies, iters)
    if want("flat94_e2e"):
        configs["flat94_e2e"] = bench_flat94_e2e(iters, collect=stats)
    if want("catalog_e2e"):
        configs["catalog_e2e"] = bench_catalog_e2e(iters, collect=stats)
    if want("dec93b"):
        # DEVICE STAGE ONLY (prescan + VM trace prebuilt outside the
        # timer) — the 1993 families' cold end-to-end number is
        # catalog_e2e.  Heterogeneous batch: two distinct music streams,
        # one per 1993 sub-family (OS93b Type 0/1, OS93a Type 0 — same
        # decompressor).
        configs["dec93b"] = _bench_93_family(
            _read(["music_a.dcs93b", "music_b.dcs93a"]), False,
            max(2, copies // 2), iters)
    if want("dec93a_t1"):
        # DEVICE STAGE ONLY — see dec93b.
        configs["dec93a_t1"] = _bench_93_family(
            _read(["dense_t1.dcs93a1", "dense_t1b.dcs93a1"]), True,
            max(2, copies // 2), iters)
    if want("session6"):
        configs["session6"] = bench_session6(iters, collect=stats)
    if want("enc94"):
        configs["enc94"] = bench_enc94(iters, collect=stats)
    if want("enc94_dev"):
        configs["enc94_dev"] = bench_enc94_dev(iters)
    if want("enc93"):
        configs["enc93"] = bench_enc93(iters)

    headline = configs.get("flat94_music",
                           configs.get("flat94",
                                       next(iter(configs.values()))))
    out = {
        "device": device,
        "metric": "batched_decode_throughput",
        "value": round(headline, 1),
        "unit": "x_realtime_per_chip",
        "vs_baseline": round(headline / 20.0, 2),
        "configs": {k: round(v, 1) for k, v in configs.items()},
    }
    if stats:
        out["stats"] = stats
    print(json.dumps(out))


if __name__ == "__main__":
    main()
