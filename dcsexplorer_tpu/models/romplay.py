"""ROM-driven device playback: command sessions and autoplay catalog sweeps.

Combines the host VM control tracer (models/pipeline.ControlTracer) with the
device pipeline to play full ROM track programs on the device — the framework's
equivalent of DCSExplorer's interactive playback and --autoplay sweep
(reference: DCSExplorer/DCSExplorer.cpp:1271-1336).
"""

import numpy as np

import jax

from ..refdec import decoder as rd
from ..rom import tracks as rtracks
from . import pipeline as pl


def _chip_stream_ref(rom_set, linear):
    p = rom_set.make_pointer(linear)
    mem = p.mem.mem if isinstance(p.mem, rd.PaddedView) else p.mem
    return mem, p.pos


def build_rom_bank(rom_set):
    """Prescan + device-decode every stream referenced by the ROM's tracks."""
    bank = pl.StreamBank(rom_set.os_version)
    for linear in rtracks.list_streams(rom_set, rom_set.os_version):
        mem, pos = _chip_stream_ref(rom_set, linear)
        bank.add(mem, pos)
    bank.decode_all()
    return bank


def compress_controls(rows, mix, max_segments=255):
    """Control-plane compression for batched session serving.

    The VM trace's per-frame controls are massively redundant on the
    wire: a playing channel's dense-row id ADVANCES BY 1 each frame
    (wrapping at loop points), an idle channel holds row 0, and the mix
    multiplier is piecewise constant between commands/fade steps.  Each
    (session, channel) lane is therefore a handful of LINEAR SEGMENTS
    ``row[t] = base + slope·(t-f0)`` with a constant mix — so instead of
    dense uint16 ``rows``/``mix`` [S,T,C] (the dominant upload on the
    serving path) the batch ships only the tiny per-segment parameter
    tables, ~25x fewer bytes, and the device
    derives the per-frame segment index from f0 and reconstructs the
    exact dense arrays (reconstruct_from_segments — bit-identical,
    asserted in tests/test_romplay.py).

    This is the generic numpy path (any dense rows/mix).  The serving
    bench never materializes dense arrays at all: the native runtime VM
    emits the same segments during the trace
    (NativeControlTracer.trace_segs — segmentation-identical, asserted
    in tests/test_romplay.py).

    rows/mix: [S, T, C] integer arrays.  Returns a dict of numpy arrays
    (f0 u16, base u16, slope u8, mixv u16 — all [S,C,E]; unused f0
    entries hold 0xFFFF) or None if any lane needs more than
    ``max_segments`` segments (callers fall back to the dense upload).
    """
    rows = np.asarray(rows, np.int64)
    mix = np.asarray(mix, np.int64)
    S, T, C = rows.shape
    assert T < 0xFFFF and rows.max(initial=0) < (1 << 16) \
        and mix.max(initial=0) < (1 << 16)
    d = rows[:, 1:] - rows[:, :-1]                      # [S, T-1, C]
    ok = (d == 0) | (d == 1)
    same_mix = mix[:, 1:] == mix[:, :-1]
    brk = ~ok | ~same_mix                               # segment starts at t
    brk[:, 1:] |= d[:, 1:] != d[:, :-1]                 # slope change
    seg_id = np.zeros((S, T, C), np.int64)
    np.cumsum(brk, axis=1, out=seg_id[:, 1:])
    n_seg = seg_id[:, -1] + 1                           # [S, C]
    E = int(n_seg.max())
    if E > max_segments:
        return None
    # first frame of each segment, per lane (vectorized scatter)
    f0 = np.full((S, C, E), 0xFFFF, np.int64)
    is_start = np.ones((S, T, C), bool)
    is_start[:, 1:] = brk
    s_i, t_i, c_i = np.nonzero(is_start)
    e_i = seg_id[s_i, t_i, c_i]
    f0[s_i, c_i, e_i] = t_i
    base = np.zeros((S, C, E), np.int64)
    base[s_i, c_i, e_i] = rows[s_i, t_i, c_i]
    mixv = np.zeros((S, C, E), np.int64)
    mixv[s_i, c_i, e_i] = mix[s_i, t_i, c_i]
    # slope = the first step's delta inside the segment (0 for 1-frame
    # segments: no step reads it)
    slope = np.zeros((S, C, E), np.int64)
    in_seg = ~is_start[:, 1:]                           # step t-1->t stays
    s_j, t_j, c_j = np.nonzero(in_seg)
    # only the FIRST continuing step per segment defines the slope; later
    # ones are equal by construction, so last-writer-wins is fine
    slope[s_j, c_j, seg_id[s_j, t_j + 1, c_j]] = d[s_j, t_j, c_j]
    return dict(f0=f0.astype(np.uint16), base=base.astype(np.uint16),
                slope=slope.astype(np.uint8), mixv=mixv.astype(np.uint16))


def pack_controls_wire(comp, vol):
    """Flatten a compressed control batch + volume into ONE uint8 wire
    buffer, so a batch costs one host-to-device transfer instead of five.
    unpack_controls_wire inverts it on device from the static shapes."""
    vol = np.asarray(vol, np.uint8)
    parts = [comp["slope"].reshape(-1), vol.reshape(-1),
             comp["f0"].astype("<u2").view(np.uint8).reshape(-1),
             comp["base"].astype("<u2").view(np.uint8).reshape(-1),
             comp["mixv"].astype("<u2").view(np.uint8).reshape(-1)]
    return np.concatenate(parts)


def unpack_controls_wire(buf, S, T, C, E):
    """Device-side inverse of pack_controls_wire.

    Returns (f0/base/mixv i32 [S,C,E], slope [S,C,E], vol [S,T])."""
    import jax.numpy as jnp
    from jax import lax
    n_par = S * C * E
    o = 0
    slope = buf[o:o + n_par].reshape(S, C, E); o += n_par
    vol = buf[o:o + S * T].reshape(S, T); o += S * T
    u16 = lambda a: lax.bitcast_convert_type(
        a.reshape(-1, 2), jnp.uint16).astype(jnp.int32)
    f0 = u16(buf[o:o + 2 * n_par]).reshape(S, C, E); o += 2 * n_par
    base = u16(buf[o:o + 2 * n_par]).reshape(S, C, E); o += 2 * n_par
    mixv = u16(buf[o:o + 2 * n_par]).reshape(S, C, E)
    return f0, base, slope, mixv, vol


def reconstruct_from_segments(f0, base, slope, mixv, n_frames):
    """Device-side inverse of compress_controls / trace_segs: exact dense
    rows/mix from the per-segment parameter tables alone.

    The per-frame segment index never travels: f0 is sorted ascending
    per lane with unused entries at 0xFFFF, so the active segment at
    frame t is ``count(f0 <= t) - 1`` (segment 0 always starts at 0).

    f0/base/slope/mixv: [S,C,E] int.  Returns (rows [S,T,C] i32,
    mix [S,T,C] i32).
    """
    import jax.numpy as jnp
    t = jnp.arange(n_frames, dtype=jnp.int32)                 # [T]
    le = f0[:, :, None, :] <= t[None, None, :, None]          # [S,C,T,E]
    e = jnp.sum(le.astype(jnp.int32), axis=-1) - 1            # [S,C,T]
    pick = lambda p: jnp.transpose(jnp.take_along_axis(
        p.astype(jnp.int32), e, axis=2), (0, 2, 1))           # [S,T,C]
    tt = t[None, :, None]
    rows = pick(base) + pick(slope) * (tt - pick(f0))
    return rows, pick(mixv)


class SessionServer:
    """Batched, pipelined multi-session serving — the library form of the
    "many cabinets, one chip" shape the serving bench measures
    (bench.bench_session6; no reference counterpart — DCSExplorer plays
    one session at a time, DCSDecoder.cpp:1579-1690 is single-stream).

    One server owns a device-resident stream bank, a native runtime-VM
    handle, the compiled decode program, and the serving pipeline's
    worker threads: a prep thread traces each batch's sessions in ONE
    GIL-releasing C call (dcstr_trace_segs_batch) and packs the
    segment-compressed control wire; an upload thread pushes the wire
    buffer AND dispatches (keeping the per-dispatch round trip off the
    consumer thread); results are fetched as batches complete, in order.

    events format: one dict per session, {frame_index: [port bytes...]}.
    Sessions are INDEPENDENT — each is traced from fresh-decoder state
    (native full_reset; the reference's soft_boot is a soft reboot that
    keeps tracks playing).  Each yielded batch is int16 PCM
    [n_sessions, n_frames*240], or ``reduce_fn``'s fetched result —
    pass a device-side reducer to fetch less than the full PCM; it
    receives the raw decoder words [S, n_frames*240]
    (u16 domain: ``((w & 0xFFFF) ^ 0x8000) - 0x8000`` is int16 PCM).

        with SessionServer(rom_set, n_sessions=64, n_frames=500) as srv:
            for pcm in srv.serve(batches_of_event_dicts):
                ...
    """

    def __init__(self, rom_set, n_sessions, n_frames, n_ch=8, seg_e=32,
                 depth=3, default_volume=0x67, bank=None, reduce_fn=None):
        from concurrent.futures import ThreadPoolExecutor

        from ..vm import native_tracer as nt
        assert nt.available(), "SessionServer needs the native runtime"
        self.rom_set = rom_set
        self.n_sessions = n_sessions
        self.n_frames = n_frames
        self.n_ch = n_ch
        self.seg_e = seg_e
        self.depth = max(1, depth)
        self.reduce_fn = reduce_fn
        self.bank = bank if bank is not None else build_rom_bank(rom_set)
        assert self.bank.total_rows() < (1 << 16), \
            "u16 row ids need a bank under 64Ki rows"
        self._addr_tab, self._off_tab = nt.stream_row_table(rom_set,
                                                            self.bank)
        self._tracer = nt.NativeControlTracer(
            rom_set, default_volume=default_volume)
        self._jit_cache = {}
        self._ex_prep = ThreadPoolExecutor(1)
        self._ex_updisp = ThreadPoolExecutor(1)

    # -- pipeline stages ------------------------------------------------
    def _prepare(self, events_list):
        """Prep thread: batch VM trace (one C call) + wire pack.  On a
        segment-cap overflow the batch retries with a doubled table
        (recompile per width, cached)."""
        assert len(events_list) == self.n_sessions, \
            (len(events_list), self.n_sessions)
        S, C, T = self.n_sessions, self.n_ch, self.n_frames
        while True:
            E = self.seg_e
            f0 = np.full((S, C, E), 0xFFFF, np.uint16)
            base = np.zeros((S, C, E), np.uint16)
            slope = np.zeros((S, C, E), np.uint8)
            mixv = np.zeros((S, C, E), np.uint16)
            vol = np.zeros((S, T), np.uint8)
            ok = self._tracer.trace_segs_batch(
                T, self._addr_tab, self._off_tab, f0, base, slope, mixv,
                vol, events_list)
            if ok:
                wire = pack_controls_wire(
                    dict(f0=f0, base=base, slope=slope, mixv=mixv), vol)
                return wire, E
            if E >= 255:
                raise ValueError("a session lane exceeds 255 segments")
            self.seg_e = min(255, E * 2)

    def _program(self, E):
        import jax
        import jax.numpy as jnp
        if E not in self._jit_cache:
            dec = self.bank.decode_fn()
            S, C, T = self.n_sessions, self.n_ch, self.n_frames
            red = self.reduce_fn

            def fn(ba, buf):
                f0, base, slope, mixv, vol = unpack_controls_wire(
                    buf, S, T, C, E)
                rows, mix = reconstruct_from_segments(f0, base, slope,
                                                      mixv, T)
                v = vol.astype(jnp.int32)
                pcm, _ = jax.vmap(lambda a, b, c: dec(ba, a, b, c))(
                    rows, mix, v)
                pcm = pcm.reshape(S, -1)          # [S, n_frames*240] words
                return red(pcm) if red is not None else pcm

            self._jit_cache[E] = jax.jit(fn)
        return self._jit_cache[E]

    def _updisp(self, wire, E):
        import jax
        buf = jax.device_put(wire)
        return self._program(E)(self.bank.bank_args(), buf)

    # -- public surface -------------------------------------------------
    def serve(self, batches):
        """Serve an iterable of batches (each: n_sessions event dicts),
        yielding each batch's fetched result in order.  The pipeline
        stays ``depth`` batches deep while the consumer iterates."""
        from collections import deque
        it = iter(batches)
        prep_q, disp_q = deque(), deque()

        def refill():
            while len(prep_q) + len(disp_q) < self.depth:
                try:
                    ev = next(it)
                except StopIteration:
                    return
                prep_q.append(self._ex_prep.submit(self._prepare, ev))

        refill()
        while prep_q or disp_q:
            if prep_q:
                wire, E = prep_q.popleft().result()
                disp_q.append(self._ex_updisp.submit(self._updisp, wire,
                                                     E))
                refill()
            if disp_q and (len(disp_q) >= self.depth or not prep_q):
                out = np.asarray(disp_q.popleft().result())
                refill()
                if self.reduce_fn is None:
                    out = ((out.reshape(self.n_sessions, -1) & 0xFFFF)
                           ^ 0x8000).astype(np.int32) - 0x8000
                    out = out.astype(np.int16)
                yield out

    def serve_one(self, events_list):
        """One batch, synchronously."""
        return next(self.serve([events_list]))

    def close(self):
        self._ex_prep.shutdown()
        self._ex_updisp.shutdown()
        if self._tracer is not None:
            self._tracer.close()
            self._tracer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def play_session(rom_set, events, n_frames, bank=None, default_volume=0x67):
    """Run a command-driven session on device.

    events: {frame_index: callable(decoder)} — e.g. write data-port bytes.
    Returns int16 PCM [n_frames * 240] (running-state frames only; boot is
    host-side and prepends silence/bong via the scalar decoder if needed).
    """
    if bank is None:
        bank = build_rom_bank(rom_set)
    tracer = pl.ControlTracer()
    tracer.default_volume = default_volume
    tracer.load_rom_set(rom_set)
    tracer.soft_boot()
    tracer.trace_frames(n_frames, events=events)

    rows, mix, vol = pl.assemble_controls(tracer, bank)
    pcm, _ = bank.jitted()(rows, mix, vol)
    pcm = np.asarray(pcm).reshape(-1)
    return (((pcm & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int16), tracer


def autoplay(rom_set, tracks=None, pad_frames=4, default_volume=0x67,
             max_frames_per_track=4000, return_tracer=False):
    """Autoplay sweep: play every type-1 track once (one iteration of its
    outermost loop), sequentially, on device.

    Returns (pcm int16 array, schedule) where schedule lists
    (track_no, start_frame, n_frames)."""
    os_v = rom_set.os_version
    if tracks is None:
        tracks = range(rom_set.n_tracks)
    plan = []
    for t in tracks:
        ti = rtracks.get_track_info(rom_set, os_v, t)
        if ti is not None and ti.type == 1 and ti.time > 0:
            plan.append((t, min(ti.time + pad_frames, max_frames_per_track)))

    bank = build_rom_bank(rom_set)
    events = {}
    schedule = []
    frame = 0
    for (t, dur) in plan:
        def make_event(track):
            def ev(dec):
                dec.clear_tracks()
                dec.write_data_port((track >> 8) & 0xFF)
                dec.write_data_port(track & 0xFF)
            return ev
        events[frame] = make_event(t)
        schedule.append((t, frame, dur))
        frame += dur
    total = frame + pad_frames

    pcm, tracer = play_session(rom_set, events, total, bank=bank,
                               default_volume=default_volume)
    if return_tracer:
        return pcm, schedule, tracer
    return pcm, schedule
