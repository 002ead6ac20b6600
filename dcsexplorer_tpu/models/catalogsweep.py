"""Heterogeneous all-family COLD catalog sweep — the test-all.bat shape.

The reference's actual integration configuration is one sweep over a mixed
catalog of EVERY format family in a single run (the corpus driver invokes
DCSExplorer per title across 94/95/93b/93a ROMs,
/root/reference/DCSDecoder/Tests/test-all.bat:27-76).  This module gives the
1993 families the same cold end-to-end treatment the 94 family has in
models/flatsweep.py, and runs all three families as one sweep:

- ``Flat93Sweep``: host half for the 1993 families.  Per catalog entry the
  native stream indexer (dcs93_index / dcs93a_index) records the per-band
  decode controls and the native runtime VM traces mix/volume; all entries'
  frames then concatenate on ONE flat frame axis — bit offsets globalize
  into a single byte pool (8-byte $FF separators, like FlatSweep), so the
  per-frame window gather addresses one buffer and heterogeneous stream
  lengths cost no padding.
- ``flat93_pipeline_packed`` / ``flat93a_pipeline_packed``: the device half
  from TRANSFER-COMPACT inputs.  A cold mixed sweep uploads the whole
  catalogue, so the wire carries ONLY what the device cannot derive:

    93b/frame: sid u16 + frame_word i32 + mix u16 + vol u8 + 16 × (packed
    kind·width u8 + frame-relative bit offset u16 + chain state 2×u16) ≈
    121 B (v1: ≈ 342 B).  Scale factors, sample counts, output strides and
    output offsets are PER-STREAM properties of the 16 header bytes, so
    they ship once per stream ([S,16] tables) and the per-frame output
    layout reconstructs on device with a 16-band cumulative sum.

    93a-T1/frame: sid u16 + frame_word i32 + mix u16 + vol u8 + 18 ×
    (width u8 + scale CODE u8 + frame-relative bit offset u16) ≈ 81 B
    (v1: ≈ 226 B).  The 32-bit scale words decompose as mantissa[2 bits]
    << shift[≤14]; the device rebuilds them with a 4-way select and a
    vector shift — no gathers.

- ``catalog_pipeline``: one jitted program over all three families' packed
  batches returning one checksum (single dispatch), for callers that want
  the whole mixed catalog in one program.  The bench instead dispatches
  per family so each family's device work overlaps the NEXT family's
  upload (bench.bench_catalog_e2e).

The overlap-add carry resets at stream starts (``overlap_resolve93_flat``),
so the flat axis is bit-exact with per-stream decode (tests/test_catalog_e2e).

Reference anchors: 1993 decompressor DCSDecoderNative.cpp:2293-2615, OS93a
Type-1 :2698-3032, the 93 transform :614-813.
"""

import numpy as np

import jax.numpy as jnp

from ..format import tables as T
from ..ops import band_decode as bd
from ..ops import decode93, decode93a
from ..ops import transform as tf
from ..refdec import decoder as rd

_SCALE_MANT = np.asarray(T.SCALE_MANTISSA, dtype=np.int64)


def _trace_standalone(stream, n_frames, os_version, mixing_level,
                      master_volume):
    """Per-frame (mix multiplier, volume shift) for standalone playback —
    native runtime VM when available, Python fallback (same contract as
    flatsweep.FlatSweep._trace)."""
    from ..vm import native_tracer as nt
    if nt.available():
        tr = nt.NativeControlTracer(stream, default_volume=master_volume,
                                    standalone_os=os_version)
        tr.soft_boot()
        tr.load_audio_stream(0, 0, mixing_level=mixing_level)
        _, _, out_m, out_v = tr.trace_frames(n_frames)
        tr.close()
        return out_m[:, 0].astype(np.int32), out_v.astype(np.int32)
    from .pipeline import ControlTracer
    tr = ControlTracer()
    tr.default_volume = master_volume
    tr.init_standalone(os_version)
    tr.soft_boot()
    tr.load_audio_stream(0, stream, mixing_level=mixing_level)
    tr.trace_frames(n_frames)
    mixes = np.zeros(n_frames, dtype=np.int32)
    for t, entries in enumerate(tr.trace_entries):
        for (c, _, fidx, m) in entries:
            if c == 0 and fidx == t:
                mixes[t] = m
    return mixes, np.asarray(tr.trace_vol_shift, dtype=np.int32)


def _stream93_band_tables(stream):
    """Per-stream per-band decode constants from the 16 header bytes
    (refdec/frames decompress_frame_93 band setup; prescan93's derivation
    of scale/n/inc/fix/stride_skip, decode93.py:84-106): scale u16, n, inc,
    pre-increment, fix, stride_skip — everything about a band's layout
    that does NOT change frame to frame."""
    fmt = (stream[2] & 0x80) >> 7
    scale = np.zeros(16, np.uint16)
    n = np.zeros(16, np.uint8)
    inc = np.ones(16, np.uint8)
    pre = np.zeros(16, np.uint8)
    fix = np.zeros(16, np.int8)
    skip = np.zeros(16, np.uint8)
    for b in range(16):
        cur = stream[2 + b] & 0x7F
        if cur == 0x7F:
            break
        sf_shift = ((cur >> 2) & 0xF) - 0xF
        mant = int(_SCALE_MANT[cur & 3])
        scale[b] = (mant << sf_shift if sf_shift >= 0
                    else mant >> -sf_shift) & 0xFFFF
        stride = cur >> 6
        if fmt == 0:
            if stride == 0:
                n[b], inc[b], fix[b], skip[b] = 16, 1, 0, 16
            else:
                n[b], inc[b], fix[b], skip[b], pre[b] = 16, 2, -1, 31, 1
        else:
            if stride == 0:
                n[b] = 15 if b == 0 else 16
                inc[b], fix[b], skip[b] = 1, 0, n[b]
            else:
                n[b], inc[b], fix[b], skip[b] = 8, 2, 0, 8
    return fmt, dict(scale=scale, n=n, inc=inc, pre=pre, fix=fix, skip=skip)


def _decompose_scale32(sc32):
    """[..,] int64 resolved 93a scale words → u8 codes (shift<<2 | mant
    index); 0xFF marks an unused band (scale 0).  Asserts exact
    reconstruction so the narrowing can never silently wrap."""
    sc32 = np.asarray(sc32, np.int64)
    out = np.full(sc32.shape, 0xFF, np.uint8)
    nz = sc32 > 0
    if nz.any():
        v = sc32[nz]
        shift = np.maximum(
            0, (np.floor(np.log2(v.astype(np.float64))) - 15)
            .astype(np.int64))
        base = v >> shift
        e = np.searchsorted(_SCALE_MANT, base)
        ok = (e < 4) & (_SCALE_MANT[np.minimum(e, 3)] == base) \
            & ((base << shift) == v) & (shift <= 14)
        assert ok.all(), "93a scale word does not decompose"
        out[nz] = (shift << 2 | e).astype(np.uint8)
    return out


class Flat93Sweep:
    """Host packing of a 1993-family catalog onto one flat frame axis.

    ``t1`` selects the OS93a Type-1 walker/kernel (decode93a); otherwise the
    93b/93a-Type-0 walker/kernel (decode93 — both subfamilies share the
    decompressor, exactly as the reference virtualizes DecoderImpl93)."""

    def __init__(self, streams, t1, mixing_level=0x64, master_volume=255):
        self.t1 = t1
        mod = decode93a if t1 else decode93
        os_v = rd.OS93A if t1 else rd.OS93B
        idxs, offs, bufs = [], [], []
        pos = 0
        for s in streams:
            idx = (decode93a.prescan93a(s, 0) if t1
                   else decode93.prescan93(s, 0))
            idxs.append(idx)
            offs.append(pos)
            body = bytes(s)
            bufs.append(body)
            bufs.append(b"\xff" * 8)
            pos += len(body) + 8
        bufs.append(b"\xff" * 8)
        self.pool_u8 = np.frombuffer(b"".join(bufs), dtype=np.uint8)
        self.nwords = max(
            (mod.window_words_needed(i, off * 8)
             for i, off in zip(idxs, offs)), default=1)

        cols = []
        tabs = []
        for k, (s, idx) in enumerate(zip(streams, idxs)):
            F = idx.n_frames
            mix, vol = _trace_standalone(s, F, os_v, mixing_level,
                                         master_volume)
            bit_base = offs[k] * 8
            fw = ((mod.frame_base_bits(idx) + bit_base) >> 5).astype(np.int64)
            c = dict(n_frames=F, frame_word=fw, mix=mix, vol=vol)
            # frame-relative bit offsets fit u16: the frame window is at
            # most nwords*32 < 2^16 bits past the frame's base word
            rel = idx.bit_start + bit_base - (fw[:, None] << 5)
            if t1:
                rel = np.where(idx.bits > 0, rel, 0)
                c.update(bits=idx.bits, bit_rel=rel,
                         code=_decompose_scale32(idx.scale32))
            else:
                data = (idx.kind >= decode93.K_DATA0) \
                    & (idx.kind <= decode93.K_DATA2)
                rel = np.where(data, rel, 0)
                c.update(kw=(idx.kind << 5) | idx.width, bit_rel=rel,
                         prv_in=idx.prv_in, prv_dl=idx.prv_dl)
                self._check_layout(s, idx)
            cols.append(c)
            if not t1:
                fmt, tab = _stream93_band_tables(s)
                tab["fmt"] = fmt
                tabs.append(tab)
        self._cols = cols
        self._tabs = tabs
        self.n_frames_total = int(sum(c["n_frames"] for c in cols))
        self.audio_samples = self.n_frames_total * 240

    @staticmethod
    def _check_layout(stream, idx):
        """The device recomputes each frame's output layout (out_start,
        out_inc, n_samp) from the per-stream band tables; verify the
        reconstruction against the walker's ground truth once per stream
        (cheap vectorized numpy)."""
        _, tab = _stream93_band_tables(stream)
        n = tab["n"].astype(np.int64)[None, :]
        kindm = idx.kind
        adv = tab["pre"].astype(np.int64)[None, :] + np.where(
            kindm == decode93.K_NONE, tab["skip"].astype(np.int64)[None, :],
            n * tab["inc"].astype(np.int64)[None, :]
            + tab["fix"].astype(np.int64)[None, :])
        start = 1 + np.cumsum(adv, axis=1) - adv \
            + tab["pre"].astype(np.int64)[None, :]
        used = kindm != decode93.K_NONE
        assert np.array_equal(start[used], idx.out_start[used]), \
            "device out_start reconstruction diverged from the walker"
        ns = np.where(used, n, 0)
        assert np.array_equal(ns[used], idx.n_samp[used])
        assert np.array_equal(
            np.broadcast_to(tab["inc"].astype(np.int64)[None, :],
                            kindm.shape)[used], idx.out_inc[used])

    def compact_host_arrays(self):
        """Transfer-compact numpy columns (narrow wire dtypes; the device
        widens to int32 and derives the per-frame layout).  Bounds asserted
        once here so the narrowing can never silently wrap."""
        cols = self._cols
        S = len(cols)
        assert S < (1 << 16), "sid is uint16"
        cat = lambda key: (np.concatenate([c[key] for c in cols])
                           if cols else np.zeros(0, np.int64))
        sid = np.repeat(np.arange(S, dtype=np.uint16),
                        [c["n_frames"] for c in cols])
        fw = cat("frame_word")
        rel = cat("bit_rel")
        mix = cat("mix")
        vol = cat("vol")
        assert fw.size == 0 or (0 <= fw.min() and fw.max() < (1 << 31))
        assert rel.size == 0 or (0 <= rel.min() and rel.max() < (1 << 16))
        assert mix.size == 0 or (0 <= mix.min() and mix.max() < (1 << 16))
        assert vol.size == 0 or (0 <= vol.min() and vol.max() < 256)
        out = dict(pool_u8=self.pool_u8, sid=sid,
                   frame_word=fw.astype(np.int32),
                   bit_rel=rel.astype(np.uint16),
                   mix_u16=mix.astype(np.uint16),
                   vol_u8=vol.astype(np.uint8))
        if self.t1:
            bits = cat("bits")
            assert bits.size == 0 or (0 <= bits.min() and bits.max() < 8)
            out.update(bits_u8=bits.astype(np.uint8),
                       code_u8=cat("code").astype(np.uint8))
        else:
            kw = cat("kw")
            pin = cat("prv_in")
            pdl = cat("prv_dl")
            assert kw.size == 0 or (0 <= kw.min() and kw.max() < 256)
            assert pin.size == 0 or (0 <= pin.min()
                                     and pin.max() < (1 << 16))
            assert pdl.size == 0 or (0 <= pdl.min()
                                     and pdl.max() < (1 << 16))
            out.update(kw_u8=kw.astype(np.uint8),
                       prv_in=pin.astype(np.uint16),
                       prv_dl=pdl.astype(np.uint16),
                       scale_tab=np.stack([t["scale"] for t in self._tabs]),
                       n_tab=np.stack([t["n"] for t in self._tabs]),
                       inc_tab=np.stack([t["inc"] for t in self._tabs]),
                       pre_tab=np.stack([t["pre"] for t in self._tabs]),
                       fix_tab=np.stack([t["fix"] for t in self._tabs]),
                       skip_tab=np.stack([t["skip"] for t in self._tabs]))
        return out


def flat93_pipeline_packed(pool_u8, frame_word, bit_rel, kw_u8, prv_in_w,
                           prv_dl_w, mix_u16, vol_u8, sid, scale_tab, n_tab,
                           inc_tab, pre_tab, fix_tab, skip_tab, nwords):
    """93b/93a-Type-0 flat sweep from transfer-compact inputs.

    Per-frame wire: packed kind·width (u8), frame-relative bit offsets
    (u16) and the differential-chain entry state (u16×2) per band, plus
    sid/frame_word/mix/vol.  Scale factors and the output layout derive on
    device from the per-stream band tables ([S,16] each): out_start is a
    16-band cumulative sum of the per-band advances, exactly the walker's
    out_idx bookkeeping (decode93.prescan93:93-167).  Window rows build
    in-program from the uint8 pool; the overlap carry resets at stream
    starts.  Bit-exact with per-stream decode (tests/test_catalog_e2e)."""
    i32 = lambda a: a.astype(jnp.int32)
    rows = bd.window_rows(i32(pool_u8), nwords)
    sid = i32(sid)
    fw = i32(frame_word)
    kw = i32(kw_u8)
    kind = kw >> 5
    width = kw & 0x1F
    scale = i32(scale_tab)[sid]                       # [N, 16]
    n_t = i32(n_tab)[sid]
    inc = i32(inc_tab)[sid]
    pre = i32(pre_tab)[sid]
    fixv = fix_tab.astype(jnp.int8).astype(jnp.int32)[sid]
    skip = i32(skip_tab)[sid]
    none = kind == decode93.K_NONE
    adv = pre + jnp.where(none, skip, n_t * inc + fixv)
    out_start = 1 + jnp.cumsum(adv, axis=1) - adv + pre
    n_samp = jnp.where(none, 0, n_t)
    arrs = {"frame_word": fw, "kind": kind, "width": width,
            "n_samp": n_samp, "bit_start": (fw[:, None] << 5) + i32(bit_rel),
            "out_start": out_start, "out_inc": inc, "scale": scale,
            "prv_in": i32(prv_in_w), "prv_dl": i32(prv_dl_w)}
    fb = decode93.decode93_frames(rows, arrs, i32(mix_u16))
    raw = tf.transform93_raw(fb, i32(vol_u8))
    sstart = sid != jnp.concatenate([sid[:1] - 1, sid[:-1]])
    return tf.overlap_resolve93_flat(raw, sstart)


def flat93a_pipeline_packed(pool_u8, frame_word, bit_rel, bits_w, code_u8,
                            mix_u16, vol_u8, sid, nwords):
    """OS93a Type-1 flat sweep from transfer-compact inputs.

    The 32-bit scale words rebuild from their u8 codes (mantissa index +
    shift) with a 4-way select and a vector left-shift — gather-free and
    integer-exact (host asserts the decomposition round-trips)."""
    i32 = lambda a: a.astype(jnp.int32)
    rows = bd.window_rows(i32(pool_u8), nwords)
    sid = i32(sid)
    fw = i32(frame_word)
    code = i32(code_u8)
    mant = jnp.where(
        (code & 3) == 0, jnp.int32(0x8000),
        jnp.where((code & 3) == 1, jnp.int32(0x9838),
                  jnp.where((code & 3) == 2, jnp.int32(0xB505),
                            jnp.int32(0xD745))))
    scale32 = jnp.where(code == 0xFF, 0,
                        jnp.left_shift(mant, jnp.clip(code >> 2, 0, 14)))
    arrs = {"frame_word": fw, "bits": i32(bits_w),
            "bit_start": (fw[:, None] << 5) + i32(bit_rel),
            "scale32": scale32}
    fb = decode93a.decode93a_frames(rows, arrs, i32(mix_u16))
    raw = tf.transform93_raw(fb, i32(vol_u8))
    sstart = sid != jnp.concatenate([sid[:1] - 1, sid[:-1]])
    return tf.overlap_resolve93_flat(raw, sstart)


def run_flat93_pcm(ca, t1, nwords):
    """Decode a compact 93-family catalog; returns the jnp pcm [N, 240]."""
    if t1:
        return flat93a_pipeline_packed(
            ca["pool_u8"], ca["frame_word"], ca["bit_rel"], ca["bits_u8"],
            ca["code_u8"], ca["mix_u16"], ca["vol_u8"], ca["sid"], nwords)
    return flat93_pipeline_packed(
        ca["pool_u8"], ca["frame_word"], ca["bit_rel"], ca["kw_u8"],
        ca["prv_in"], ca["prv_dl"], ca["mix_u16"], ca["vol_u8"], ca["sid"],
        ca["scale_tab"], ca["n_tab"], ca["inc_tab"], ca["pre_tab"],
        ca["fix_tab"], ca["skip_tab"], nwords)


def run_flat93(sweep: Flat93Sweep):
    """Decode the packed 93-family catalog; returns int16 PCM [N*240]."""
    import functools

    import jax
    ca = sweep.compact_host_arrays()
    fn = jax.jit(functools.partial(run_flat93_pcm, t1=sweep.t1,
                                   nwords=sweep.nwords))
    pcm = np.asarray(fn(ca))
    return (((pcm & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int16).reshape(-1)


def catalog_pipeline(args94, args93b, args93a, n_steps94, nw93, nw93a):
    """ONE device program over a mixed 94 + 93b + 93a-T1 catalog.

    args94: the flatsweep.flat_pipeline_packed argument dict (compact);
    args93b/args93a: compact dicts from Flat93Sweep.  Returns the summed
    PCM checksum.  The bench dispatches the three families separately so
    device work overlaps the next family's upload; this fused form remains
    for single-dispatch callers and the equivalence test."""
    from . import flatsweep
    total = jnp.int32(0)
    if args94 is not None:
        pcm94 = flatsweep.flat_pipeline_packed(
            args94["pool_u8"], args94["sid"], args94["start_bit"],
            args94["bt_u8"], args94["mix_u16"], args94["vol_u8"],
            args94["hdr_tab"], args94["fmt_tab"], args94["sub_tab"],
            n_steps94)
        total = total + jnp.sum(pcm94 & 0xFF, dtype=jnp.int32)
    if args93b is not None:
        pcm93 = run_flat93_pcm(args93b, False, nw93)
        total = total + jnp.sum(pcm93 & 0xFF, dtype=jnp.int32)
    if args93a is not None:
        pcm93a = run_flat93_pcm(args93a, True, nw93a)
        total = total + jnp.sum(pcm93a & 0xFF, dtype=jnp.int32)
    return total
