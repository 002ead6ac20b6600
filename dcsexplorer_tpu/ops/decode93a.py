"""OS93a Type-1 (Judge Dredd) device decode: host prescan + static kernel.

The format (refdec/frames.decompress_frame_93a_type1; reference:
DCSDecoderNative.cpp:2698-3032): per band, a Huffman bit-width prefix from
one of four selector-chosen codebooks, a two-level scale codeword feeding a
wrapping scale-code chain, then fixed-width samples where EACH input yields
TWO outputs via a 256-pair lookup table.

Device shape: the host walker records per-band bit offsets, widths, and the
resolved 32-bit scale words; every band's output span is static (skipped
bands still advance by 2×inputs), so the device kernel is pure gathers +
elementwise math with a static concatenation into the frame buffer — no
scan, no scatter.
"""

from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from ..format import tables as T
from ..refdec.bitreader import BitReader, PaddedView
from .fixmath import M16, s16

N_BANDS = 18
INPUTS = np.asarray(T.OS93A_INPUTS_PER_BAND, dtype=np.int64)     # [18]
OUT_BASE = np.concatenate([[0], np.cumsum(2 * INPUTS)])          # [19]
TOTAL_OUT = int(OUT_BASE[-1])                                    # 250
MAX_IN = int(INPUTS.max())                                       # 14
_PAIR = np.asarray(T.OS93A_PAIR_TABLE, dtype=np.int32)
# the two outputs of each input packed into one word: one table gather
# instead of two (entry i = pair[2i]<<16 | pair[2i+1], both 16-bit fields)
_PAIR_PACKED = ((_PAIR[0::2].astype(np.int64) & 0xFFFF) << 16) \
    | (_PAIR[1::2].astype(np.int64) & 0xFFFF)
_PAIR_PACKED = _PAIR_PACKED.astype(np.int32)

# the packed table re-sliced by sample width: subtable w covers packed
# indices [2^w, 2^(w+1)) (index = (1<<w)+raw).  All 14 samples of a band
# share one width, so the device fetches a band's 64-entry row by a
# cheap 7-way one-hot and resolves samples with a 64-way one-hot
# contraction — no per-sample table gather.
_PAIR_BYW = np.zeros((7, 64), dtype=np.int32)
for _w in range(7):
    _n = 1 << _w
    _seg = _PAIR_PACKED[_n:2 * _n]
    _PAIR_BYW[_w, :min(_n, 64)] = _seg[:64]


@dataclass
class Stream93aIndex:
    n_frames: int
    selector: int
    bits: np.ndarray        # [F,18] sample bit width (0 = skipped band)
    bit_start: np.ndarray   # [F,18] absolute bit offset of first sample
    scale32: np.ndarray     # [F,18] resolved 32-bit scale word
    end_bit: np.ndarray     # [F]


def prescan93a(mem, pos=0, prefer_native=True):
    """Walk an OS93a Type-1 stream, recording per-band decode controls.

    Uses the C++ host runtime when available (native/src/dcs_native.cpp
    dcs93a_index, field-identical); falls back to this Python walker."""
    if prefer_native:
        try:
            from .. import native
            raw = mem.mem if isinstance(mem, PaddedView) else mem
            nd = native.index93a(bytes(raw), pos)
        except Exception:
            nd = None
        if nd is not None:
            return nd
    mem = PaddedView(mem)
    n_frames = (int(mem[pos]) << 8) | int(mem[pos + 1])
    hdr = int(mem[pos + 2])
    selector = hdr & 0x60
    num_bands = hdr & 0x1F
    bit = BitReader(mem, pos + 3)

    band_books = np.asarray(T.OS93A_BAND_BITS_CODEBOOKS, dtype=np.int64)
    scale_book = np.asarray(T.OS93A_SCALE_CODEBOOK, dtype=np.int64)
    book_base = selector >> 1

    F = n_frames
    idx = Stream93aIndex(
        n_frames=F, selector=selector,
        bits=np.zeros((F, N_BANDS), dtype=np.int64),
        bit_start=np.zeros((F, N_BANDS), dtype=np.int64),
        scale32=np.zeros((F, N_BANDS), dtype=np.int64),
        end_bit=np.zeros(F, dtype=np.int64))

    for f in range(F):
        prv_scale_code = 0x1A
        for band in range(min(num_bands, N_BANDS)):
            ele = band_books[book_base + bit.peek(4)]
            band_bits = int(ele[0]) & M16
            bit.get(int(ele[1]))
            if band_bits == 0xFFFF:
                break
            if band_bits == 0:
                continue

            sc = scale_book[bit.peek(4)]
            bit.get(int(sc[1]))
            if (int(sc[0]) & M16) == 0xFFFF:
                sc = scale_book[int(sc[2]) + bit.peek(4)]
                bit.get(int(sc[1]) - 4)

            scale_code = prv_scale_code + int(sc[0]) - 1 + band_bits * 2
            if scale_code > 0x39:
                scale_code -= 0x36
            prv_scale_code = scale_code - band_bits * 2

            shift = scale_code >> 2
            exponent = scale_code & 3
            scale = 0x8000
            for _ in range(exponent):
                scale = (scale * 0x9838) >> 15
            scale = (scale << shift) & 0xFFFFFFFF

            n = int(INPUTS[band])
            idx.bits[f, band] = band_bits
            idx.scale32[f, band] = scale
            idx.bit_start[f, band] = bit.pos * 8 - bit.nbits
            for _ in range(n):
                bit.get(band_bits)
        idx.end_bit[f] = bit.pos * 8 - bit.nbits
    return idx


def frame_base_bits(idx: Stream93aIndex):
    """Per-frame first-bit offsets (stream-relative); see
    decode93.frame_base_bits."""
    base = np.empty(idx.n_frames, dtype=np.int64)
    base[1:] = idx.end_bit[:-1]
    d0 = idx.bits[0] > 0
    base[0] = idx.bit_start[0][d0].min() if d0.any() else idx.end_bit[0]
    return base


def window_words_needed(idx: Stream93aIndex, bit_base=0):
    """Static row width (words) for the one-gather-per-frame kernel."""
    if idx.n_frames == 0:
        return 1
    base = frame_base_bits(idx) + bit_base
    word = base >> 5
    span = (idx.end_bit + bit_base) - (word << 5)
    return int((span.max() + 31) // 32)


def index_arrays(idx: Stream93aIndex, bit_base=0):
    return {
        "frame_word": jnp.asarray((frame_base_bits(idx) + bit_base) >> 5,
                                  jnp.int32),
        "bits": jnp.asarray(idx.bits, jnp.int32),
        "bit_start": jnp.asarray(idx.bit_start + bit_base, jnp.int32),
        "scale32": jnp.asarray(idx.scale32, jnp.int32),
    }


def decode93a_frames(pool_quads, idx_arrays, mix, fb_prev=None):
    """Device decode of F frames into frame buffers [F, 512].

    pool_quads: [W, ≥window_words_needed] uint32 row windows
    (band_decode.window_rows); mix: [F].  All band output spans are
    static, so the result assembles by slicing — no scatter.
    """
    from . import band_decode as bd
    bits = idx_arrays["bits"]
    bit_start = idx_arrays["bit_start"]
    scale32 = idx_arrays["scale32"]
    F = bits.shape[0]
    if fb_prev is None:
        fb_prev = jnp.zeros((F, 512), jnp.int32)

    s_in = jnp.arange(MAX_IN, dtype=jnp.int32).reshape(1, 1, MAX_IN)
    w = bits[:, :, None]
    live = (s_in < jnp.asarray(INPUTS, jnp.int32).reshape(1, N_BANDS, 1)) \
        & (w > 0)
    w1 = jnp.maximum(w, 1)

    # fixed-width samples: ONE row gather per FRAME serves all 18 bands —
    # the frame's bands are contiguous in the bitstream, so a
    # window_words_needed-wide row anchored at the frame's base word
    # covers every read (the wider word-select chain is cheap elementwise
    # work).  Skipped bands (bits 0) carry bit_start 0:
    # their clamped garbage is dropped by the `live` mask.
    fw = idx_arrays["frame_word"]
    rows = pool_quads[fw][:, None, :]               # [F, 1, NW]
    d = (bit_start - (fw[:, None] << 5))[:, :, None] + s_in * w1
    raw = bd.quad_extract(rows[:, :, None, :], d, jnp.broadcast_to(
        w1, d.shape))
    raw = raw & ((1 << w1) - 1)                     # unsigned

    # each input yields two outputs via the pair table at (2<<bits)+2*raw.
    # The width is band-constant, so the band's 64-entry packed row comes
    # from a 7-way one-hot and each sample resolves with a 64-way one-hot
    # contraction — gather-free (XLA fuses both reductions)
    ohw = (w[:, :, 0:1] == jnp.arange(7, dtype=jnp.int32)[None, None])
    rows_p = jnp.sum(jnp.where(ohw[:, :, :, None],
                               jnp.asarray(_PAIR_BYW)[None, None], 0),
                     axis=2)                        # [F, 18, 64]
    ohr = (jnp.clip(raw, 0, 63)[:, :, :, None]
           == jnp.arange(64, dtype=jnp.int32)[None, None, None])
    packed = jnp.sum(jnp.where(ohr, rows_p[:, :, None, :], 0), axis=3)
    pair0 = packed >> 16                            # s16 applied below
    pair1 = packed & M16

    # effective scale folds the mixing multiplier (reference :2941-2947)
    eff = ((scale32[:, :, None] >> 16) * (mix[:, None, None] & M16)) >> 15

    # interleave the two outputs per input: [F, 18, MAX_IN, 2] → [F, 18, 2*MAX_IN]
    outs = jnp.stack([pair0, pair1], axis=-1)
    vals = outs.reshape(F, N_BANDS, 2 * MAX_IN)
    live2 = jnp.repeat(live, 2, axis=2)
    eff2 = jnp.repeat(eff * jnp.ones_like(raw), 2, axis=2)

    # static per-band slices of the previous accumulator
    old_bands = []
    for b in range(N_BANDS):
        lo, n = int(OUT_BASE[b]), int(INPUTS[b]) * 2
        seg = fb_prev[:, lo:lo + n]
        if n < 2 * MAX_IN:
            seg = jnp.pad(seg, ((0, 0), (0, 2 * MAX_IN - n)))
        old_bands.append(seg)
    out_old = jnp.stack(old_bands, axis=1)          # [F, 18, 2*MAX_IN]

    prod = (s16(vals) * s16(eff2)) << 1
    mr = (s16(out_old) << 16) + prod
    res = mr + 0x8000
    res = jnp.where((prod & M16) == 0x8000, res & ~0x10000, res)
    new_val = (res >> 16) & M16
    new_val = jnp.where(live2, new_val, out_old & M16)

    # assemble by static slicing (band spans are contiguous from position 0)
    segs = [new_val[:, b, :int(INPUTS[b]) * 2] for b in range(N_BANDS)]
    front = jnp.concatenate(segs, axis=1)           # [F, TOTAL_OUT]
    return jnp.concatenate([front, fb_prev[:, TOTAL_OUT:]], axis=1)
