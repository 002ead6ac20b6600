"""Flat-frame catalog sweep: the fastest decode path.

Instead of a padded [streams, frames] batch (models/batched.py), all frames
of all streams are packed into ONE flat frame axis:

- stream bitstreams concatenate into a single byte pool; per-frame bit
  offsets become global, so the scan's window gather addresses one buffer
- no padding waste for heterogeneous stream lengths
- the scan length is the catalog's maximum dense-slot count (bucketing
  frames by dense count was evaluated and rejected: on typical material
  ~85% of frames sit within 25% of the max, so per-bucket scan lengths
  recover <2% — not worth the permutation and multi-program complexity)
- format type/subtype become per-frame data, so mixed-format catalogs decode
  in one program
- overlap-add remains a pure shift along the flat axis, with the carry
  zeroed at stream starts

Bit-exactness is preserved throughout (validated against the scalar
decoder / compiled reference in tests).
"""

import numpy as np

import jax
import jax.numpy as jnp

from ..format import tables as T
from ..ops import band_decode as bd
from ..ops import prescan
from ..ops import transform as tf
from ..refdec import decoder as rd

# Constants used inside traced code MUST be numpy, never eager jax.Arrays:
# tracing a function that closes over a device array forces a device->host
# literal fetch at lowering time and inlines the array into the program as
# a constant.  tests/test_no_device_consts.py enforces this for every
# device program.
_OUT_COUNT = bd._OUT_COUNT                       # numpy [16]


def band_controls_dyn(header, fmt_type, sub_type, band_type, band_type_prev):
    """Per-band controls with per-frame header/format (all [N, ...] arrays).

    Same semantics as ops/band_decode.band_controls, but fmt_type [N] and
    sub_type [N] are data, so one program serves mixed-format catalogs.
    """
    hdr = header
    active = (hdr & 0x7F) != 0x7F
    active = jnp.cumprod(active.astype(jnp.int32), axis=1).astype(bool)

    cur_hdr = hdr & 0x7F
    out_count = jnp.asarray(_OUT_COUNT.reshape(1, 16)) * jnp.ones_like(band_type)
    out_inc = jnp.where((cur_hdr & 0x40) != 0, 2, 1)
    out_count = jnp.where(out_inc == 2, out_count // 2, out_count)

    # type-1 path (all table lookups gather-free: 16-way select chains
    # over static tables — see band_decode._sel16_cols/_sel16_flat)
    btp = jnp.clip(band_type_prev, 0, 15)
    pre0 = bd._sel16_flat(bd._PREADJ[0], btp)
    pre3 = bd._sel16_flat(bd._PREADJ[1], btp)
    padd = jnp.where((sub_type != 0)[:, None], pre3, pre0)
    pre = jnp.where(jnp.arange(16).reshape(1, 16) < 3, padd, 0)
    hdr_adj = cur_hdr + pre
    bt = jnp.clip(band_type, 0, 15)
    code1 = bd._sel16_cols(bd._XT_BY_BAND, bt)
    scale_code1 = hdr_adj + bd._sel16_cols(bd._XA_BY_BAND, bt)

    is1 = (fmt_type != 0)[:, None]
    code = jnp.where(is1, code1, band_type)
    scale_code = jnp.where(is1, scale_code1, cur_hdr)
    code = jnp.where(band_type == 0, 0, code)

    has_data = active & (band_type != 0)
    code = jnp.where(has_data, code, 0)
    dense = jnp.where(has_data, out_count, 0)
    advance = jnp.where(active & (band_type == 0), out_count,
                        jnp.where(has_data, out_count * out_inc, 0))
    # scale value intentionally omitted: slot_controls derives it from the
    # scale code packed into the control word (one source of truth)
    return {"code": code,
            "scale_code": scale_code * jnp.ones_like(band_type),
            "dense": dense,
            "out_inc": out_inc * jnp.ones_like(band_type), "advance": advance}


def decode_flat(pool_words, start_bit, header, fmt_type, sub_type,
                band_type, band_type_prev, n_steps):
    """Symbol-decode N frames against the global byte pool.

    pool_words: [W, nwords] precomputed row windows (bd.window_quads;
    the group size follows the width); start_bit: [N] global
    bit offsets; header/band_type/_prev: [N, 16]; fmt/sub: [N].
    Returns (position-ordered values [N, 256], (scale, total)).
    """
    ctl = band_controls_dyn(header, fmt_type, sub_type, band_type,
                            band_type_prev)
    packed, scale, total = bd.slot_controls(ctl)
    N = start_bit.shape[0]
    K = bd.symbols_per_row(pool_words)    # row width sets the group size

    def group(carry, packed_g):            # packed_g: [K, N]
        cursor, skip = carry
        # ONE row gather per K symbols: the 128-bit quad window at the
        # group-entry cursor covers all K worst-case-width symbols
        base = cursor >> 5
        quad = pool_words[base]            # [N, nwords] uint32
        d = cursor & 31
        samples = []
        for k in range(K):
            packed_t = packed_g[k]
            ok = packed_t != 0
            c = packed_t & 0x1F
            mw = (packed_t >> bd._P_MAXW) & 0x1F
            cb = (packed_t >> bd._P_CB) & 0x3FF
            look = bd.quad_extract(quad, d, mw)
            is_cb = c <= 6
            entry = bd.cb_entry(cb + look)
            two_zero = is_cb & ((entry & 0x80) != 0)
            sample_cb = (entry & 0x7F) - (1 << jnp.clip(c - 1, 0, 14))
            mw1 = jnp.maximum(mw, 1)
            sample_raw = look - ((look >> (mw1 - 1)) << mw1)
            consume = ok & ~skip
            nbits = jnp.where(is_cb, entry >> 8, mw)
            sample = jnp.where(is_cb, sample_cb, sample_raw) & 0xFFFF
            sample = jnp.where(two_zero | skip | ~ok, 0, sample)
            d = d + jnp.where(consume, nbits, 0)
            skip = jnp.where(skip, False, consume & two_zero)
            samples.append(sample)
        return ((base << 5) + d, skip), jnp.stack(samples)

    n_groups = -(-n_steps // K)
    S = n_groups * K
    pk = packed[:, :min(S, packed.shape[1])]
    if S > pk.shape[1]:
        pk = jnp.pad(pk, ((0, 0), (0, S - pk.shape[1])))
    xs = jnp.transpose(pk).reshape(n_groups, K, N)
    _, vals = jax.lax.scan(group, (start_bit.astype(jnp.int32),
                                   jnp.zeros(N, bool)), xs)
    dense = jnp.transpose(vals.reshape(S, N))
    if S < 256:
        dense = jnp.pad(dense, ((0, 0), (0, 256 - S)))
    else:
        dense = dense[:, :256]
    return dense, (scale, total)


def flat_pipeline(pool_words, start_bit, header, fmt_type, sub_type,
                  band_type, band_type_prev, mix, vol_shift, stream_start,
                  n_steps):
    """Full flat decode: symbols → dequant → transform → overlap resolve.

    stream_start: [N] bool, True at each stream's first frame (overlap carry
    resets there).  Returns pcm [N, 240] u16 storage.
    """
    dense, ctl = decode_flat(pool_words, start_bit, header, fmt_type,
                             sub_type, band_type, band_type_prev, n_steps)
    fb = bd.dequant_mix(dense, ctl, mix)
    re, im = tf.transform94_planar(fb, vol_shift)
    return tf.overlap_resolve_planar(re, im, stream_start)


def flat_pipeline_packed(pool_u8, sid, start_bit, bt_u8, mix_u16, vol_u8,
                         hdr_tab, fmt_tab, sub_tab, n_steps):
    """The flat sweep from TRANSFER-COMPACT inputs (cold-path shape).

    A cold sweep uploads the whole catalogue, so the upload carries the
    minimum: the raw byte pool as uint8 (not int32 — 4x), band types as
    uint8, mix as uint16, volume as uint8, and the 16-byte stream header
    ONCE per stream (hdr_tab [S,16] + sid [N] instead of a broadcast
    [N,16] header).  Everything else is DERIVED on device:

      band_type_prev[f] = band_type[f-1] within a stream (zero at stream
      starts) — so btp never travels;
      stream_start[f]   = sid[f] != sid[f-1] — so sstart never travels;
      window rows       = built in-program from the uint8 pool.

    Bit-exact with flat_pipeline on the wide arrays (tests/test_batched).
    """
    N = sid.shape[0]
    pool_words = bd.window_quads(pool_u8.astype(jnp.int32))
    sid = sid.astype(jnp.int32)
    header = hdr_tab.astype(jnp.int32)[sid]
    fmt_type = fmt_tab.astype(jnp.int32)[sid]
    sub_type = sub_tab.astype(jnp.int32)[sid]
    bt = bt_u8.astype(jnp.int32)
    prev_sid = jnp.concatenate([sid[:1] - 1, sid[:-1]])
    sstart = sid != prev_sid
    btp = jnp.where(sstart[:, None],
                    0, jnp.concatenate([bt[:1], bt[:-1]], axis=0))
    dense, ctl = decode_flat(pool_words, start_bit.astype(jnp.int32),
                             header, fmt_type, sub_type, bt, btp, n_steps)
    fb = bd.dequant_mix(dense, ctl, mix_u16.astype(jnp.int32))
    re, im = tf.transform94_planar(fb, vol_u8.astype(jnp.int32))
    return tf.overlap_resolve_planar(re, im, sstart)


class FlatSweep:
    """Host-side packing of a whole catalog for the flat pipeline.

    Per catalog entry the host runs the native stream indexer (frame
    boundaries, band-type chains) and the native runtime VM trace (mixing
    multipliers, volume shifts), then assembles the per-frame control
    arrays with vectorized numpy.  The cold path ships the
    transfer-compact layout (compact_host_arrays + flat_pipeline_packed)
    and overlaps packing with the upload (bench.py bench_flat94_e2e)."""

    def __init__(self, streams, mixing_level=0x64, master_volume=0x67):
        idxs = [prescan.prescan94(s, 0) for s in streams]
        offsets = []
        bufs = []
        pos = 0
        for s, i in zip(streams, idxs):
            offsets.append(pos)
            end = int(i.end_bit[-1] // 8) + 8 if i.n_frames else len(s)
            body = bytes(s[:end])            # may clamp short of `end`
            bufs.append(body)
            bufs.append(b"\xff" * 8)
            pos += len(body) + 8
        bufs.append(b"\xff" * 8)
        # the pool stays uint8 on the host: the cold path ships it as-is
        # (flat_pipeline_packed widens on device); the wide args() path
        # widens lazily
        self.pool_u8 = np.frombuffer(b"".join(bufs), dtype=np.uint8)

        cols = []      # per stream: dict of per-frame numpy columns
        for k, (s, i) in enumerate(zip(streams, idxs)):
            F = i.n_frames
            mixes, vols = self._trace(s, F, mixing_level, master_volume)
            cols.append(dict(
                n_frames=F,
                start_bit=(offsets[k] * 8 + i.start_bit).astype(np.int32),
                header=np.asarray(i.header, np.int32),       # [16], one row
                fmt=int(i.fmt_type), sub=int(i.sub_type),
                bt=np.asarray(i.band_type, np.int32),
                btp=np.asarray(i.band_type_prev, np.int32),
                mix=mixes, vol=vols,
                totals=np.asarray(prescan.scan_totals(i), np.int64),
            ))
        self._cols = cols
        self.n_frames_total = int(sum(c["n_frames"] for c in cols))
        self.audio_samples = self.n_frames_total * 240
        self.dense_totals = (np.concatenate([c["totals"] for c in cols])
                             if cols else np.zeros(0, np.int64))

    @staticmethod
    def _trace(stream, n_frames, mixing_level, master_volume):
        """Per-frame (mix multiplier, volume shift) for standalone
        playback — native runtime VM when available, Python fallback."""
        from ..vm import native_tracer as nt
        if nt.available():
            tr = nt.NativeControlTracer(stream, default_volume=master_volume,
                                        standalone_os=rd.OS94)
            tr.soft_boot()
            tr.load_audio_stream(0, 0, mixing_level=mixing_level)
            _, _, out_m, out_v = tr.trace_frames(n_frames)
            tr.close()
            return out_m[:, 0].astype(np.int32), out_v.astype(np.int32)
        from .pipeline import ControlTracer
        tr = ControlTracer()
        tr.default_volume = master_volume
        tr.init_standalone(rd.OS94)
        tr.soft_boot()
        tr.load_audio_stream(0, stream, mixing_level=mixing_level)
        tr.trace_frames(n_frames)
        mixes = np.zeros(n_frames, dtype=np.int32)
        for t, entries in enumerate(tr.trace_entries):
            for (c, _, fidx, m) in entries:
                if c == 0 and fidx == t:
                    mixes[t] = m
        return mixes, np.asarray(tr.trace_vol_shift, dtype=np.int32)

    def pack(self):
        """Assemble the transfer-compact catalog columns (the cold-path
        wire layout — nothing wider than the device needs is ever built;
        the wide args() arrays derive lazily from the same per-stream
        columns)."""
        cols = self._cols
        S = len(cols)
        N = self.n_frames_total
        cat = lambda key: (np.concatenate([c[key] for c in cols])
                           if cols else np.zeros(0, np.int32))
        assert S < (1 << 16), "sid is uint16"
        self.sid = np.repeat(np.arange(S, dtype=np.uint16),
                             [c["n_frames"] for c in cols])
        self.start_bit = cat("start_bit").astype(np.int32)
        # full-width band types (type-1 streams accumulate deltas mod
        # 0x10000, so values above 255 are legitimate); the compact wire
        # narrows to uint8 and asserts
        self.bt = (np.concatenate([c["bt"] for c in cols])
                   if cols else np.zeros((0, 16), np.int32))
        mix = cat("mix")
        vol = cat("vol")
        assert mix.size == 0 or mix.max() < (1 << 16)
        assert vol.size == 0 or vol.max() < 256
        assert self.start_bit.size == 0 or self.start_bit.max() < (1 << 31)
        self.mix_u16 = mix.astype(np.uint16)
        self.vol_u8 = vol.astype(np.uint8)
        self.hdr_tab = (np.stack([c["header"] for c in cols])
                        if S else np.zeros((0, 16), np.int32)) \
            .astype(np.uint8)
        self.fmt_tab = np.asarray([c["fmt"] for c in cols], np.uint8)
        self.sub_tab = np.asarray([c["sub"] for c in cols], np.uint8)
        self.n_steps = int(min(256, (self.dense_totals.max() + 7) & ~7)) \
            if N else 8
        return self

    def args(self):
        """The wide flat_pipeline argument tuple (built on demand — the
        cold path never pays for these int32 broadcasts)."""
        cols = self._cols
        sid = self.sid.astype(np.int32)
        header = (self.hdr_tab.astype(np.int32)[sid] if len(cols)
                  else np.zeros((0, 16), np.int32))
        fmt = self.fmt_tab.astype(np.int32)[sid] if len(cols) \
            else np.zeros(0, np.int32)
        sub = self.sub_tab.astype(np.int32)[sid] if len(cols) \
            else np.zeros(0, np.int32)
        btp = (np.concatenate([c["btp"] for c in cols])
               if cols else np.zeros((0, 16), np.int32))
        sstart = np.concatenate([[True], sid[1:] != sid[:-1]]) \
            if sid.size else np.zeros(0, bool)
        return (jnp.asarray(self.pool_u8.astype(np.int32)),
                jnp.asarray(self.start_bit),
                jnp.asarray(header), jnp.asarray(fmt),
                jnp.asarray(sub), jnp.asarray(self.bt),
                jnp.asarray(btp), jnp.asarray(self.mix_u16.astype(np.int32)),
                jnp.asarray(self.vol_u8.astype(np.int32)),
                jnp.asarray(sstart),
                self.n_steps)

    def compact_host_arrays(self):
        """Transfer-compact numpy columns for flat_pipeline_packed
        (requires pack()).  ~4 bytes/pool-byte + ~23 bytes/frame less on
        the wire than args(); see flat_pipeline_packed."""
        bt = self.bt
        assert bt.size == 0 or (0 <= bt.min() and bt.max() <= 255), \
            "band types exceed uint8 — use the wide args() path"
        return dict(
            pool_u8=self.pool_u8,
            sid=self.sid,
            start_bit=self.start_bit,
            bt_u8=bt.astype(np.uint8),
            mix_u16=self.mix_u16,
            vol_u8=self.vol_u8,
            hdr_tab=self.hdr_tab,
            fmt_tab=self.fmt_tab, sub_tab=self.sub_tab,
            n_steps=self.n_steps)


def run_flat(sweep: FlatSweep):
    """Decode the whole packed catalog; returns int16 PCM [N*240]."""
    args = list(sweep.args())
    args[0] = bd.window_quads(args[0])
    fn = jax.jit(flat_pipeline, static_argnums=(10,))
    pcm = np.asarray(fn(*args))
    return (((pcm & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int16).reshape(-1)
