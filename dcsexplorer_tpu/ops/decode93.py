"""1993-family device decode: host prescan + scan-free band kernel.

The 93 frame format has NO per-sample Huffman coding — every band's samples
are fixed-width — so once the host prescan records each band's bit offset,
width, subtype, scale, and the differential-chain state entering the band,
the device decodes every sample of every frame with pure gathers and
cumulative sums: no lax.scan at all.

Band semantics being vectorized: refdec/frames.decompress_frame_93
(reference anchors: DCSDecoderNative.cpp:2293-2615), including the
subtype-1 repeat path's replicated rounding anomaly (closed form below).
"""

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from ..format import tables as T
from ..refdec.bitreader import BitReader, PaddedView
from ..refdec.frames import _read_huff93
from .fixmath import M16, s16, sat16

# band kinds
K_NONE, K_DATA0, K_DATA1, K_DATA2, K_REPEAT, K_RAMP = 0, 1, 2, 3, 4, 5


@dataclass
class Stream93Index:
    n_frames: int
    fmt_type: int
    # per frame, per band slot (max 16 bands):
    kind: np.ndarray        # [F,16] band kind (K_*)
    width: np.ndarray       # [F,16] sample bit width (data kinds)
    n_samp: np.ndarray      # [F,16] samples/outputs in the band
    bit_start: np.ndarray   # [F,16] absolute bit offset of first sample
    out_start: np.ndarray   # [F,16] frame-buffer index of first output
    out_inc: np.ndarray     # [F,16]
    scale: np.ndarray       # [F,16] scale factor (u16)
    prv_in: np.ndarray      # [F,16] chain value entering the band
    prv_dl: np.ndarray      # [F,16] chain delta entering the band
    end_bit: np.ndarray     # [F]


def prescan93(mem, pos=0, prefer_native=True):
    """Walk a 93-format stream, recording per-band decode controls.

    Uses the C++ host runtime when available (native/src/dcs_native.cpp
    dcs93_index, field-identical); falls back to this Python walker."""
    if prefer_native:
        try:
            from .. import native
            raw = mem.mem if isinstance(mem, PaddedView) else mem
            nd = native.index93(bytes(raw), pos)
        except Exception:
            nd = None
        if nd is not None:
            return nd
    mem = PaddedView(mem)
    n_frames = (int(mem[pos]) << 8) | int(mem[pos + 1])
    hdr_pos = pos + 2
    fmt_type = (int(mem[hdr_pos]) & 0x80) >> 7
    bit = BitReader(mem, hdr_pos + 16)

    F = n_frames
    z = lambda: np.zeros((F, 16), dtype=np.int64)
    idx = Stream93Index(n_frames=F, fmt_type=fmt_type, kind=z(), width=z(),
                        n_samp=z(), bit_start=z(), out_start=z(), out_inc=z(),
                        scale=z(), prv_in=z(), prv_dl=z(),
                        end_bit=np.zeros(F, dtype=np.int64))
    band_type_acc = [0] * 16

    for f in range(F):
        band_sub_type = 0 if fmt_type == 1 else 2
        is_first = True
        prv_in = 0
        prv_dl = 0
        reuse = False
        cur_type = 0
        out_idx = 1
        for band in range(16):
            cur_hdr = int(mem[hdr_pos + band]) & 0x7F
            if cur_hdr == 0x7F:
                break
            sf_index = cur_hdr & 3
            sf_shift = ((cur_hdr >> 2) & 0xF) - 0xF
            stride = cur_hdr >> 6
            mant = int(T.SCALE_MANTISSA[sf_index])
            scale = (mant << sf_shift if sf_shift >= 0 else mant >> -sf_shift) & M16

            if fmt_type == 0:
                if stride == 0:
                    n, inc, fix = 16, 1, 0
                    stride_skip = 16
                else:
                    out_idx += 1
                    n, inc, fix = 16, 2, -1
                    stride_skip = 31
            else:
                if stride == 0:
                    n = 15 if is_first else 16
                    inc, fix, stride_skip = 1, 0, n
                else:
                    n, inc, fix, stride_skip = 8, 2, 0, 8

            if reuse:
                reuse = bit.get(1) != 0
            if not reuse:
                if fmt_type == 0:
                    if bit.get(1):
                        if bit.get(1):
                            band_sub_type = (1, 2, 0)[band_sub_type]
                        else:
                            band_sub_type = (2, 0, 1)[band_sub_type]
                    cur_type = bit.get(4)
                else:
                    delta, band_sub_type = _read_huff93(bit, band_sub_type)
                    band_type_acc[band] = (band_type_acc[band] + delta) & M16
                    cur_type = band_type_acc[band]

            idx.scale[f, band] = scale
            idx.out_inc[f, band] = inc
            idx.prv_in[f, band] = prv_in
            idx.prv_dl[f, band] = prv_dl

            if cur_type == 0:
                reuse = True
                if band_sub_type == 0:
                    idx.kind[f, band] = K_NONE
                    out_idx += stride_skip
                    prv_in = 0
                    prv_dl = 0
                elif band_sub_type == 1:
                    idx.kind[f, band] = K_REPEAT
                    idx.n_samp[f, band] = n
                    idx.out_start[f, band] = out_idx
                    out_idx += n * inc + fix
                    prv_dl = 0
                else:
                    idx.kind[f, band] = K_RAMP
                    idx.n_samp[f, band] = n
                    idx.out_start[f, band] = out_idx
                    out_idx += n * inc + fix
                    prv_in = (prv_in + n * prv_dl) & M16
            else:
                width = cur_type + (1 if fmt_type == 0 else 0)
                idx.kind[f, band] = (K_DATA0, K_DATA1, K_DATA2)[band_sub_type]
                idx.width[f, band] = width
                idx.n_samp[f, band] = n
                idx.bit_start[f, band] = bit.pos * 8 - bit.nbits
                idx.out_start[f, band] = out_idx
                # read (and fold) the samples to advance + track the chain
                vals = [bit.get_signed(width) & M16 for _ in range(n)]
                if band_sub_type == 0:
                    prv_in = vals[-1]
                    prv_dl = (vals[-1] - vals[-2]) & M16
                elif band_sub_type == 1:
                    for v in vals:
                        prv_dl = v
                        prv_in = (prv_in + v) & M16
                else:
                    for v in vals:
                        prv_dl = (prv_dl + v) & M16
                        prv_in = (prv_in + prv_dl) & M16
                out_idx += n * inc + fix
            is_first = False
        idx.end_bit[f] = bit.pos * 8 - bit.nbits
    return idx


def frame_base_bits(idx: Stream93Index):
    """Per-frame first-bit offsets (stream-relative): frame f's reads all
    lie in [frame_base[f], end_bit[f]).  Frames are contiguous in the
    bitstream, so frame_base[f] = end_bit[f-1]; frame 0's base is its
    first data-band read (or end_bit[0] if the frame carries no data)."""
    base = np.empty(idx.n_frames, dtype=np.int64)
    base[1:] = idx.end_bit[:-1]
    d0 = (idx.kind[0] >= K_DATA0) & (idx.kind[0] <= K_DATA2)
    base[0] = idx.bit_start[0][d0].min() if d0.any() else idx.end_bit[0]
    return base


def window_words_needed(idx: Stream93Index, bit_base=0):
    """Static row width (words) so one row gather per FRAME covers every
    band read of that frame: max over frames of the span from the frame's
    base word to its end bit."""
    if idx.n_frames == 0:
        return 1
    base = frame_base_bits(idx) + bit_base
    word = base >> 5
    span = (idx.end_bit + bit_base) - (word << 5)
    return int((span.max() + 31) // 32)


def decode93_frames(pool_rows, idx_arrays, mix, fb_prev=None):
    """Device decode of F frames' bands into frame buffers [F, 512].

    idx_arrays: dict of jnp arrays from a Stream93Index (kind, width, n_samp,
    bit_start, out_start, out_inc, scale, prv_in, prv_dl each [F, 16], plus
    frame_word [F]); pool_rows: [W, ≥window_words_needed] uint32 row windows
    (band_decode.window_rows — the whole FRAME's bands come out of one row
    gather); mix: [F].
    """
    from . import band_decode as bd
    kind = idx_arrays["kind"]
    width = idx_arrays["width"]
    n_samp = idx_arrays["n_samp"]
    bit_start = idx_arrays["bit_start"]
    out_start = idx_arrays["out_start"]
    out_inc = idx_arrays["out_inc"]
    scale = idx_arrays["scale"]
    prv_in = idx_arrays["prv_in"]
    prv_dl = idx_arrays["prv_dl"]
    F = kind.shape[0]

    no_prev = fb_prev is None
    if no_prev:
        fb_prev = jnp.zeros((F, 512), jnp.int32)
    outbuf1 = fb_prev[:, 1]

    i16 = jnp.arange(16, dtype=jnp.int32).reshape(1, 1, 16)     # sample idx
    kindx = kind[:, :, None]
    w = width[:, :, None]
    live = i16 < n_samp[:, :, None]

    # fixed-width sample extraction with ONE row gather per FRAME: a
    # frame's bands are CONTIGUOUS in the bitstream, so a single
    # window_words_needed-wide row anchored at the frame's base word
    # serves every band — 16× fewer gathers than one-per-band (the wider
    # word-select chain in quad_extract is cheap elementwise work).
    # Non-data bands carry bit_start 0: their (negative→uint32-huge)
    # offsets produce clamped garbage that the `live & kind` mask drops.
    w1 = jnp.maximum(w, 1)
    fw = idx_arrays["frame_word"]
    rows = pool_rows[fw][:, None, :]                            # [F, 1, NW]
    d = (bit_start - (fw[:, None] << 5))[:, :, None] + i16 * w  # [F, 16, 16]
    raw = bd.quad_extract(rows[:, :, None, :], d,
                          jnp.broadcast_to(w1, d.shape))
    raw = raw & ((1 << w1) - 1)
    samp = (raw - ((raw >> (w1 - 1)) << w1)) & M16              # sign-extend

    samp = jnp.where(live & (kindx >= K_DATA0) & (kindx <= K_DATA2), samp, 0)

    # differential chains via cumulative sums (mod 2^16 is preserved by
    # int32 adds + masking at the end)
    c1 = jnp.cumsum(samp, axis=2)
    c2 = jnp.cumsum(c1, axis=2)
    p_in = prv_in[:, :, None]
    p_dl = prv_dl[:, :, None]
    vals_d0 = samp
    vals_d1 = (p_in + c1) & M16
    vals_d2 = (p_in + (i16 + 1) * p_dl + c2) & M16
    vals_ramp = (p_in + (i16 + 1) * p_dl) & M16

    vals = jnp.where(kindx == K_DATA1, vals_d1,
                     jnp.where(kindx == K_DATA2, vals_d2,
                               jnp.where(kindx == K_RAMP, vals_ramp, vals_d0)))

    # the exact scale/mix accumulate (reference AddOutput)
    sc = scale[:, :, None]
    mixv = mix[:, None, None] & M16
    fbi = out_start[:, :, None] + i16 * out_inc[:, :, None]
    if no_prev:
        out_old = jnp.zeros((F, 16, 16), jnp.int32)   # first voice: empty
    else:
        out_old = jnp.take_along_axis(
            fb_prev, jnp.clip(fbi, 0, 511).reshape(F, 256),
            axis=1).reshape(F, 16, 16)

    scaled = (s16(vals) * (sc & M16)) & M16
    prod = ((s16(out_old) << 16) | scaled) + s16(scaled) * mixv
    acc_new = (prod >> 16) & M16

    # subtype-1 repeat anomaly, closed form: the product's low word carries
    # across iterations as L_k = (L0 + k*M) mod 2^16 with
    # L0 = low16(prv_in*scale), M = low16(s16(L0)*mix)
    l0 = (s16(p_in) * (sc & M16)) & M16
    pl = s16(l0)
    m_low = (pl * mixv) & M16
    l_enter = (l0 + i16 * m_low) & M16
    prod_r = ((s16(out_old) << 16) | l_enter) + pl * mixv
    rep_new = (prod_r >> 16) & M16

    new_val = jnp.where(kindx == K_REPEAT, rep_new, acc_new)
    write = live & (kindx != K_NONE)

    # Placement WITHOUT a scatter: every frame-buffer position is written
    # by at most one (band, sample) cell per frame (band output spans
    # advance monotonically and never overlap), so a fused broadcast-
    # compare-reduce over the 256 cells places the values exactly.  A
    # scatter, a host-built inverse permutation + take_along and an
    # old|new packed-word variant are the alternatives.
    tgtf = jnp.where(write, fbi, 512).reshape(F, 256, 1)
    valf = new_val.reshape(F, 256, 1)
    hit = tgtf == jnp.arange(512, dtype=jnp.int32).reshape(1, 1, 512)
    sums = jnp.sum(jnp.where(hit, valf, 0), axis=1)
    if no_prev:
        fb = sums
    else:
        fb = jnp.where(jnp.any(hit, axis=1), sums, fb_prev)

    # first-sample delta fixup (reference :2608-2611)
    delta = sat16(s16(fb[:, 1]) - s16(outbuf1))
    fb = fb.at[:, 0].set(sat16(s16(delta) + s16(fb[:, 0])))
    fb = fb.at[:, 1].set(outbuf1)
    return fb


def index_arrays(idx: Stream93Index, bit_base=0):
    """Stream93Index → jnp arrays dict (bit offsets shifted by bit_base)."""
    return {
        "frame_word": jnp.asarray((frame_base_bits(idx) + bit_base) >> 5,
                                  jnp.int32),
        "kind": jnp.asarray(idx.kind, jnp.int32),
        "width": jnp.asarray(idx.width, jnp.int32),
        "n_samp": jnp.asarray(idx.n_samp, jnp.int32),
        "bit_start": jnp.asarray(idx.bit_start + bit_base, jnp.int32),
        "out_start": jnp.asarray(idx.out_start, jnp.int32),
        "out_inc": jnp.asarray(idx.out_inc, jnp.int32),
        "scale": jnp.asarray(idx.scale, jnp.int32),
        "prv_in": jnp.asarray(idx.prv_in, jnp.int32),
        "prv_dl": jnp.asarray(idx.prv_dl, jnp.int32),
    }
