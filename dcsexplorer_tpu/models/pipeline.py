"""Device decode pipeline: host VM control + device numerics.

Architecture (SURVEY.md §7): the branchy, pointer-chasing runtime — track
byte-code VM, command queue, mixer fades, volume — runs on host as a cheap
*control tracer* (a stubbed ``ReferenceDecoder`` that skips all per-sample
math), emitting per-frame control vectors: which stream frame plays on which
channel at what mixing multiplier, plus the global volume shift.  The device
then executes the entire numeric pipeline for ALL frames in parallel:

  bitstream symbol decode (ops/band_decode.decode_frames94)
  → dequant/scale/mix accumulate over channels (dequant_mix)
  → inverse transform (ops/transform.transform94_planar)
  → overlap-add resolve (pure shift, no scan)

Every PCM word is bit-exact with the scalar reference decoder.
"""

import numpy as np

import jax
import jax.numpy as jnp

from ..format import tables as T
from ..ops import band_decode as bd
from ..ops import prescan
from ..ops import transform as tf
from ..refdec import decoder as rd
from ..vm.tracer import ControlTracer


class StreamBank:
    """Prescanned + device-decoded streams (the HBM-resident bitstream pool).

    Holds, for every registered stream, the dense per-frame sample values and
    slot controls produced by the device symbol-decode kernel, concatenated
    into global arrays indexed by (stream, frame).
    """

    def __init__(self, os_version):
        self.os_version = os_version
        # 94/95 family decodes ahead of time into dense arrays; the 93
        # family decodes per session from the bitstream pool + prescan index
        self.family93 = os_version in (rd.OS93A, rd.OS93B)
        self.keys = {}
        self._streams = []

    def add(self, mem, pos=0):
        key = (id(mem), pos)
        if key in self.keys:
            return key
        if self.family93:
            fmt1_93a = (self.os_version == rd.OS93A
                        and (int(mem[pos + 2]) & 0x80) != 0)
            if fmt1_93a:
                from ..ops import decode93a
                idx = decode93a.prescan93a(mem, pos)
            else:
                from ..ops import decode93
                idx = decode93.prescan93(mem, pos)
            data_end = (int(idx.end_bit[-1]) // 8 + 8) if idx.n_frames \
                else pos + 18
            raw = np.frombuffer(bytes(mem[pos:data_end + 4]) + b"\xff" * 8,
                                dtype=np.uint8)
            self.keys[key] = len(self._streams)
            self._streams.append((idx, raw, pos, fmt1_93a))
            return key
        idx = prescan.prescan94(mem, pos)
        if idx.error_frame >= 0:
            raise ValueError(f"stream error at frame {idx.error_frame}")
        data_end = int(idx.end_bit[-1] // 8 + 8) if idx.n_frames else pos + 18
        raw = np.frombuffer(bytes(mem[pos:data_end + 4]) + b"\xff" * 8, dtype=np.uint8)
        self.keys[key] = len(self._streams)
        self._streams.append((idx, raw, pos))
        return key

    def decode_all(self):
        """Run the device symbol-decode kernel for every stream; build the
        global dense-value/slot-control arrays.

        ONE jitted program decodes the whole bank (the flat-sweep symbol
        kernel with per-frame format columns) and the results STAY on
        device: no per-stream compile, no device->host fetch (a fetch
        here would serialize the bank build)."""
        if self.family93:
            return self._build93()
        from . import flatsweep
        offsets = {}
        pool = bytearray()
        cols = []
        total = 1  # row 0 is the silent dummy row
        n_steps = 8
        for key, si in self.keys.items():
            idx, raw, pos = self._streams[si]
            F = idx.n_frames
            # prescan bit offsets are absolute in mem; raw starts at pos
            rel_start = (idx.start_bit - pos * 8).astype(np.int64)
            cols.append(dict(
                start_bit=(len(pool) * 8 + rel_start).astype(np.int32),
                header=np.broadcast_to(
                    np.asarray(idx.header, np.int32), (F, 16)),
                fmt=np.full(F, int(idx.fmt_type), np.int32),
                sub=np.full(F, int(idx.sub_type), np.int32),
                bt=np.asarray(idx.band_type, np.int32),
                btp=np.asarray(idx.band_type_prev, np.int32)))
            pool += bytes(raw)
            if F:
                n_steps = max(n_steps,
                              min(256, (int(prescan.scan_totals(idx).max())
                                        + 7) & ~7))
            offsets[key] = total
            total += F
        pool += b"\xff" * 8
        cat = lambda k: np.concatenate([c[k] for c in cols]) if cols \
            else np.zeros((0,), np.int32)
        N = total - 1
        pool_bytes = np.frombuffer(bytes(pool), np.uint8).astype(np.int32)

        def build(pool_bytes, start_bit, header, fmt, sub, bt, btp):
            rows = bd.window_quads(pool_bytes)
            dense, (scale, tot) = flatsweep.decode_flat(
                rows, start_bit, header, fmt, sub, bt, btp, n_steps)
            z = jnp.zeros((1, 256), jnp.int32)
            return (jnp.concatenate([z, dense]),
                    jnp.concatenate([z, scale]),
                    jnp.concatenate([jnp.zeros(1, jnp.int32), tot]))

        hdr = (np.concatenate([c["header"] for c in cols])
               if cols else np.zeros((0, 16), np.int32))
        bt = (np.concatenate([c["bt"] for c in cols])
              if cols else np.zeros((0, 16), np.int32))
        btp = (np.concatenate([c["btp"] for c in cols])
               if cols else np.zeros((0, 16), np.int32))
        self.dense, self.scale, self.total = jax.jit(build)(
            pool_bytes, cat("start_bit"), hdr, cat("fmt"), cat("sub"),
            bt, btp)
        self.offsets = offsets
        return self

    def _build93(self):
        """93-family: concatenate the streams into one bitstream pool and
        stack the prescan indices into global per-frame-row arrays (row 0 =
        silent dummy); decode runs per session in device_decode."""
        from ..ops import decode93, decode93a
        pool = bytearray()
        offsets = {}
        rows93, rows93a = [], []
        total = 1
        nwords = 1
        for key, si in self.keys.items():
            idx, raw, pos, is93a = self._streams[si]
            bit_base = len(pool) * 8 - pos * 8
            pool += bytes(raw)
            F = idx.n_frames
            if is93a:
                a = decode93a.index_arrays(idx, bit_base=bit_base)
                rows93a.append((total, {k: np.asarray(v) for k, v in a.items()}, F))
                nwords = max(nwords,
                             decode93a.window_words_needed(idx, bit_base))
            else:
                a = decode93.index_arrays(idx, bit_base=bit_base)
                rows93.append((total, {k: np.asarray(v) for k, v in a.items()}, F))
                nwords = max(nwords,
                             decode93.window_words_needed(idx, bit_base))
            offsets[key] = total
            total += F

        def stack(rows, keys_shapes):
            out = {k: np.zeros((total,) + shp, dtype=np.int32)
                   for k, shp in keys_shapes.items()}
            for (base, arrs, F) in rows:
                for k in out:
                    out[k][base:base + F] = arrs[k]
            return {k: jnp.asarray(v) for k, v in out.items()}

        self.idx93 = stack(rows93, {
            "frame_word": (), "kind": (16,), "width": (16,), "n_samp": (16,),
            "bit_start": (16,), "out_start": (16,), "out_inc": (16,),
            "scale": (16,), "prv_in": (16,), "prv_dl": (16,)})
        self.idx93a = stack(rows93a, {
            "frame_word": (),
            "bits": (decode93a.N_BANDS,),
            "bit_start": (decode93a.N_BANDS,),
            "scale32": (decode93a.N_BANDS,)})
        self.has93 = bool(rows93)
        self.has93a = bool(rows93a)
        pool += b"\xff" * 8
        pool_bytes = np.frombuffer(bytes(pool), dtype=np.uint8).astype(np.int32)
        # one row gather per frame: rows wide enough for the largest frame
        # (jitted: one program instead of eager op-by-op dispatches)
        self.pool_quads = jax.jit(bd.window_rows, static_argnums=(1,))(
            pool_bytes, nwords)
        self.offsets = offsets
        return self

    def total_rows(self):
        """Number of global dense rows (incl. the silent dummy row 0)."""
        return 1 + sum(
            self._streams[si][0].n_frames for si in self.keys.values())

    def bank_args(self):
        """The bank's device-resident arrays, to pass as EXPLICIT jit
        arguments (device-resident args transfer nothing per call).

        Never close a traced function over these: a captured device array
        is fetched to host at lowering time and inlined into the program
        as a constant (see tests/test_no_device_consts.py).
        """
        if self.family93:
            return (self.pool_quads, self.idx93, self.idx93a)
        return (self.dense, self.scale, self.total)

    def decode_fn(self):
        """The pure session-decode function for this bank's format family:
        ``fn(bank_args, rows, mix, vol_shift, overlap0=None)`` with no
        captured arrays (family flags ride as static closure booleans)."""
        if not self.family93:
            return device_decode
        import functools
        return functools.partial(device_decode93, has93=self.has93,
                                 has93a=self.has93a)

    def jitted(self):
        """A cached jit of the session decode (reused across sessions so
        each new session with the same bank skips retracing); the bank
        arrays are bound per CALL as device-resident arguments."""
        if not hasattr(self, "_jit_fn"):
            self._jit_fn = jax.jit(self.decode_fn())
        return lambda rows, mix, vol_shift, overlap0=None: self._jit_fn(
            self.bank_args(), rows, mix, vol_shift,
            jnp.zeros(16, jnp.int32) if overlap0 is None else overlap0)

    def device_decode(self, rows, mix, vol_shift, overlap0=None):
        """Decode T runtime frames on device for this bank's format family.

        Compat surface: calls the pure function eagerly.  Do NOT wrap this
        bound method in jax.jit/vmap — it captures the bank arrays; use
        ``decode_fn()`` + ``bank_args()`` instead."""
        return self.decode_fn()(self.bank_args(), rows, mix, vol_shift,
                                overlap0)


def device_decode93(bank93, rows, mix, vol_shift, overlap0=None,
                    has93=True, has93a=True):
    """93-family session decode; bank93 = (pool_quads, idx93, idx93a)."""
    from ..ops import decode93, decode93a
    pool_quads, idx93, idx93a = bank93
    rows = jnp.asarray(rows, jnp.int32)
    mix = jnp.asarray(mix, jnp.int32)
    vol_shift = jnp.asarray(vol_shift, jnp.int32)
    Tn = rows.shape[0]
    if overlap0 is None:
        overlap0 = jnp.zeros(16, jnp.int32)
    fb = jnp.zeros((Tn, 512), jnp.int32)
    # rows may carry fewer than MAX_CHANNELS lanes: a dropped lane is
    # always row 0 (silent) and contributes nothing, so the serving path
    # can upload only the channels a session actually uses
    for c in range(rows.shape[-1]):
        r = rows[:, c]
        # zero-filled rows of the other kind contribute nothing, so both
        # kernels chain unconditionally
        if has93:
            arrs = {k: v[r] for k, v in idx93.items()}
            fb = decode93.decode93_frames(pool_quads, arrs,
                                          mix[:, c], fb_prev=fb)
        if has93a:
            arrs = {k: v[r] for k, v in idx93a.items()}
            fb = decode93a.decode93a_frames(pool_quads, arrs,
                                            mix[:, c], fb_prev=fb)
    raw = tf.transform93_raw(fb, vol_shift)
    return tf.overlap_resolve93(raw, overlap0)


def assemble_controls(tracer: ControlTracer, bank: StreamBank):
    """Convert the VM trace into dense device control arrays.

    Returns (rows [T, 8] global dense-row per channel (0 = silent),
             mix [T, 8], vol_shift [T])."""
    T_ = len(tracer.trace_vol_shift)
    rows = np.zeros((T_, rd.MAX_CHANNELS), dtype=np.int32)
    mix = np.zeros((T_, rd.MAX_CHANNELS), dtype=np.int32)
    for t, entries in enumerate(tracer.trace_entries):
        for (c, key, fidx, m) in entries:
            rows[t, c] = bank.offsets[key] + fidx
            mix[t, c] = m
    vol = np.asarray(tracer.trace_vol_shift, dtype=np.int32)
    return rows, mix, vol


def device_decode(bank_arrays, rows, mix, vol_shift, overlap0=None):
    """Decode T runtime frames on device; bit-exact with the scalar decoder.

    bank_arrays: (dense, scale, total) global stream-frame arrays;
    rows/mix: [T, 8]; vol_shift: [T].  Returns pcm [T, 240] u16 storage.
    """
    dense_all, scale_all, total_all = bank_arrays
    rows = jnp.asarray(rows, jnp.int32)
    mix = jnp.asarray(mix, jnp.int32)
    vol_shift = jnp.asarray(vol_shift, jnp.int32)
    Tn = rows.shape[0]
    if overlap0 is None:
        overlap0 = jnp.zeros(16, jnp.int32)

    fb = jnp.zeros((Tn, 512), jnp.int32)
    # fewer than MAX_CHANNELS lanes allowed: dropped lanes are always
    # row 0 (active=False) and contribute nothing (serving upload path)
    for c in range(rows.shape[-1]):
        r = rows[:, c]
        active = r > 0
        ctl = (scale_all[r], total_all[r])
        fb = bd.dequant_mix(dense_all[r], ctl, mix[:, c], fb_prev=fb,
                            active=active)

    re, im = tf.transform94_planar(fb, vol_shift)
    pcm, last_ov = tf.overlap_resolve_planar_state(re, im, overlap0)
    return pcm, last_ov


def decode_standalone(streams, os_version=rd.OS94, default_volume=0x67,
                      n_frames=None, events=None):
    """End-to-end standalone decode on device.

    streams: list of (mem, channel, mixing_level) loaded at frame 0.
    Returns int16 PCM [n_frames * 240].
    """
    bank = StreamBank(os_version)
    for (mem, _, _) in streams:
        bank.add(mem, 0)
    bank.decode_all()

    tracer = ControlTracer()
    tracer.default_volume = default_volume
    tracer.init_standalone(os_version)
    tracer.soft_boot()
    for (mem, ch, lvl) in streams:
        tracer.load_audio_stream(ch, mem, mixing_level=lvl)
    if n_frames is None:
        n_frames = 4 + max(prescan.prescan94(mem, 0).n_frames
                           for (mem, _, _) in streams)
    tracer.trace_frames(n_frames, events=events)

    rows, mix, vol = assemble_controls(tracer, bank)
    pcm, _ = bank.jitted()(rows, mix, vol)
    pcm = np.asarray(pcm).reshape(-1)
    return ((pcm & 0xFFFF) ^ 0x8000).astype(np.int32) - 0x8000
