"""Device frame decode (1994+ family): batched Huffman value decode, dequant,
scale and mix — every frame in parallel.

Given the host prescan index (ops/prescan.py), each frame is independent:
its bit offset and absolute band types are known, so the kernel runs a short
``lax.scan`` over sample symbols with the *frame batch* as the vector axis,
then dequantizes and mixes into per-frame 512-word frame buffers with the
exact fixed-point accumulate.

Design notes:
- Per-band → per-slot control expansion uses scatter-diff + cumsum along the
  slot axis (piecewise-constant expansion), avoiding any [F,256,16] tensors.
- The scan's ONLY gather is one window row per group of symbols
  (window_rows/quad_extract); slot controls stream in as scan xs (sliced,
  not gathered) and codebook entries compute gather-free (cb_entry's
  boundary-sum).  Everything else is branchless elementwise arithmetic.
- The scan length is the maximum symbol count over the frame batch (from the
  prescan), not the worst-case 256.

Semantics anchors: reference DCSDecoderNative.cpp:1836-2261 (band loop,
codebooks, scaling, accumulate); ops/fixmath.py for the numerics contract.
All arrays use u16-in-int32 storage; arithmetic relies on int32 wrapping.
"""

import numpy as np

import jax
import jax.numpy as jnp

from ..format import tables as T
from .fixmath import M16, s16, sat16

# flattened codebooks: entry = (consumed_bits << 8) | value; value bit $80 =
# "emit two zeros"
_CB_SIZES = [4, 8, 32, 128, 256, 512]
_CB_BASE = np.zeros(7, dtype=np.int32)
for _i in range(1, 7):
    _CB_BASE[_i] = _CB_BASE[_i - 1] + (_CB_SIZES[_i - 2] if _i >= 2 else 0)
_CB_FLAT = np.concatenate([np.asarray(T.CODEBOOKS[i], dtype=np.int32)
                           for i in range(1, 7)])
_MAXW = np.asarray(T.MAX_BIT_WIDTH, dtype=np.int32)          # [7]

# gather-free codebook lookup: _CB_FLAT is piecewise constant (132 runs),
# so entry(idx) = V0 + sum_k [idx >= b_k] * (V_k - V_{k-1}) — a chain of
# fused elementwise compare/add ops instead of one random-access gather
# per lane per scan step.  Out-of-range idx (raw-width lanes) sums
# every delta and lands on the LAST entry — exactly what the clamped
# gather produced, so the substitution is bit-identical.
_chg = np.nonzero(_CB_FLAT[1:] != _CB_FLAT[:-1])[0] + 1
_CB_RUN_BOUNDS = _chg.astype(np.int32)
_CB_RUN_BASE = int(_CB_FLAT[0])
_CB_RUN_DELTAS = (_CB_FLAT[_chg].astype(np.int64)
                  - _CB_FLAT[_chg - 1].astype(np.int64)).astype(np.int32)


def cb_entry(idx):
    """Codebook entry for flat index [N] without a gather (see above)."""
    e = jnp.full(idx.shape, _CB_RUN_BASE, jnp.int32)
    for b, d in zip(_CB_RUN_BOUNDS.tolist(), _CB_RUN_DELTAS.tolist()):
        e = e + jnp.where(idx >= b, jnp.int32(d), jnp.int32(0))
    return e
_XLAT_TYPE = np.stack([  # [3 groups, 16] translated band type
    np.asarray(T.XLAT02[:, 0]), np.asarray(T.XLAT35[:, 0]),
    np.asarray(T.XLAT6F[:, 0])]).astype(np.int32)
_XLAT_ADJ = np.stack([
    np.asarray(T.XLAT02[:, 1]), np.asarray(T.XLAT35[:, 1]),
    np.asarray(T.XLAT6F[:, 1])]).astype(np.int32)
_BAND_GROUP = np.array([0] * 3 + [1] * 3 + [2] * 10, dtype=np.int32)  # [16]
_PREADJ = np.stack([np.asarray(T.PREADJ0), np.asarray(T.PREADJ3)]).astype(np.int32)
_OUT_COUNT = np.asarray(T.BAND_OUTPUT_COUNT, dtype=np.int32)  # [16]
_SCALE_MANT = np.asarray(T.SCALE_MANTISSA, dtype=np.int32)    # [4]

# packed per-symbol control layout:
#   code | maxw<<5 | cb_base<<10 | valid<<20 | scale_code<<21
#   | (out_inc-1)<<27 | start_parity<<28
_P_CODE, _P_MAXW, _P_CB, _P_VALID, _P_SCALE = 0, 5, 10, 20, 21
_P_INC2, _P_PAR = 27, 28


def window_rows(stream_bytes, nwords):
    """[L] byte array (int32) → [W, nwords] uint32 row windows, where row j
    holds the nwords big-endian 32-bit words covering bytes 4j..4j+4n-1.

    One ROW gather yields a 32·nwords-bit window serving several
    max-width (17-bit) symbols after worst-case 31-bit alignment — so a
    scan's window gather runs once per symbols_per_row() symbols instead
    of once per symbol.  The caller pads the byte array with ≥4·nwords
    trailing bytes.
    """
    b = jnp.concatenate([stream_bytes.astype(jnp.uint32),
                         jnp.full(4 * nwords, 0xFF, jnp.uint32)])
    L = b.shape[0]
    W = L // 4
    words = ((b[0:W * 4:4] << 24) | (b[1:W * 4:4] << 16)
             | (b[2:W * 4:4] << 8) | b[3:W * 4:4])
    rows = [words]
    for k in range(1, nwords):
        rows.append(jnp.concatenate([words[k:], words[:k]]))
    return jnp.stack(rows, axis=1)                    # [W, nwords] uint32


def window_quads(stream_bytes):
    """128-bit (4-word) windows: 5 max-width symbols per row gather — the
    symbol scans' row width.  On the H100 8-word rows (13 symbols per
    gather) run within a few per cent of it either way between 95k and
    284k frames and take twice as long to compile (PERF.md)."""
    return window_rows(stream_bytes, 4)


def symbols_per_row(rows):
    """Max symbols one row window can serve: (32·nwords - 31) // 17."""
    return (32 * rows.shape[-1] - 31) // 17


def quad_extract(quad, d, mw):
    """Bits [d, d+mw) of a row window ([..., nwords] uint32), as int32.

    d + mw must stay inside the row (symbols_per_row symbols per row);
    fields cross at most one word boundary.  All shifts are uint32
    (logical).
    """
    d = jnp.asarray(d).astype(jnp.uint32)
    mw = jnp.asarray(mw).astype(jnp.uint32)
    wi = d >> 5
    n = quad.shape[-1]
    w_lo = quad[..., n - 1]
    w_hi = quad[..., n - 1]
    for k in range(n - 2, -1, -1):
        w_lo = jnp.where(wi == k, quad[..., k], w_lo)
        w_hi = jnp.where(wi == k, quad[..., k + 1], w_hi)
    s = (d & 31) + mw                     # end offset within w_lo/w_hi pair
    mask = (jnp.uint32(1) << mw) - 1
    # every operand stays uint32 (mixed-signedness promotion would turn the
    # right shifts arithmetic); both where-branches evaluate, so every
    # shift amount is clamped valid
    lo_part = w_lo >> jnp.clip(jnp.uint32(32) - jnp.minimum(s, 32), 0, 31)
    hi_part = (w_lo << jnp.clip(s - jnp.minimum(s, 32), 0, 31)) \
        | (w_hi >> jnp.clip(jnp.uint32(64) - jnp.maximum(s, 33), 1, 31))
    val = jnp.where(s > 32, hi_part, lo_part) & mask
    return val.astype(jnp.int32)



# static per-band lookup tables flattened for gather-free selection: the
# band axis is static, so XT[band, v] chains as 16 fused compare/selects
# with per-band constant columns instead of an [F,16] HBM gather
_XT_BY_BAND = _XLAT_TYPE[_BAND_GROUP]            # [16 bands, 16 values]
_XA_BY_BAND = _XLAT_ADJ[_BAND_GROUP]


def _sel16_cols(tab, idx):
    """tab: static [16 bands, 16 values]; idx: [F, 16] in 0..15.
    out[f, b] = tab[b, idx[f, b]] via 16 fused selects (no gather)."""
    out = jnp.zeros_like(idx)
    for v in range(16):
        col = jnp.asarray(tab[:, v], jnp.int32).reshape(1, -1)
        out = jnp.where(idx == v, col, out)
    return out


def _sel16_flat(tab, idx):
    """tab: static [16] values; idx: [F, 16] in 0..15 (16 fused selects)."""
    out = jnp.zeros_like(idx)
    for v in range(16):
        out = jnp.where(idx == v, int(tab[v]), out)
    return out


def _sel4_mant(sel):
    """Scale mantissa by low 2 bits, gather-free."""
    m2 = sel & 3
    return jnp.where(m2 == 0, 0x8000,
                     jnp.where(m2 == 1, 0x9838,
                               jnp.where(m2 == 2, 0xB505, 0xD745)))


def band_controls(header, sub_type, fmt_type, band_type, band_type_prev):
    """Per-band control vectors for a batch of frames (all int32).

    header: [16] stream header bytes; sub_type/fmt_type: python ints;
    band_type, band_type_prev: [F, 16].

    Returns dict of [F, 16] arrays: code (effective band type; 0 = no data),
    scale (u16 scale factor), dense (dense outputs), out_inc (1|2),
    advance (frame-buffer index advance for the band).
    """
    hdr = jnp.asarray(header, jnp.int32).reshape(1, 16)
    active = (hdr & 0x7F) != 0x7F
    # the $7F terminator ends the band list: mask every band at or after it
    active = jnp.cumprod(active.astype(jnp.int32), axis=1).astype(bool)

    cur_hdr = hdr & 0x7F
    out_count = jnp.asarray(_OUT_COUNT).reshape(1, 16) * jnp.ones_like(band_type)
    out_inc = jnp.where((cur_hdr & 0x40) != 0, 2, 1) * jnp.ones_like(band_type)
    out_count = jnp.where(out_inc == 2, out_count // 2, out_count)

    if fmt_type == 0:
        code = band_type
        scale_code = cur_hdr * jnp.ones_like(band_type)
    else:
        padd = _PREADJ[1 if sub_type != 0 else 0]
        pre = jnp.where(jnp.arange(16).reshape(1, 16) < 3,
                        _sel16_flat(padd, jnp.clip(band_type_prev, 0, 15)), 0)
        hdr_adj = cur_hdr + pre
        bt = jnp.clip(band_type, 0, 15)
        code = _sel16_cols(_XT_BY_BAND, bt)
        scale_code = hdr_adj + _sel16_cols(_XA_BY_BAND, bt)
        code = jnp.where(band_type == 0, 0, code)

    has_data = active & (band_type != 0)
    code = jnp.where(has_data, code, 0)
    scale_code_out = scale_code * jnp.ones_like(band_type)
    dense = jnp.where(has_data, out_count, 0)
    # frame-buffer advance: halved count when skipped, count*inc when decoded
    # (replicates the reference's asymmetric skip advance, :1886 vs :2244)
    advance = jnp.where(active & (band_type == 0), out_count,
                        jnp.where(has_data, out_count * out_inc, 0))
    # NOTE: the scale VALUE is not returned — slot_controls derives it
    # elementwise from the scale code packed into the control word, keeping
    # one source of truth (the end-to-end parity suites pin the result).
    return {"code": code, "scale_code": scale_code_out,
            "dense": dense, "out_inc": out_inc, "advance": advance}


def _expand(starts, values, n_slots):
    """Piecewise-constant expansion: out[f, d] = values[f, max b: starts[f,b] <= d].

    starts: [F, 16] nondecreasing; values: [F, 16].  Bands sharing a start
    (zero-width) telescope so the last one wins, matching band ordering.
    Boundary-sum formulation: out = sum_b [starts_b <= d] * diff_b — 16
    fused compare/add passes over [F, n_slots], no scatter and no cumsum.
    """
    diffs = jnp.concatenate(
        [values[:, :1], values[:, 1:] - values[:, :-1]], axis=1)
    dgrid = jnp.arange(n_slots, dtype=jnp.int32).reshape(1, n_slots)
    out = jnp.zeros((starts.shape[0], n_slots), jnp.int32)
    for b in range(starts.shape[1]):
        out = out + jnp.where(starts[:, b:b + 1] <= dgrid,
                              diffs[:, b:b + 1], 0)
    return out


def slot_controls(ctl, n_slots=256):
    """Expand per-band controls to per-POSITION slot controls.

    The scan axis IS the frame-buffer position axis (fb index − 1): each
    active band occupies its position span; bands with data put symbol
    control words there, while skipped bands and decimated (out_inc=2) gaps
    hold zero words (emit 0, consume nothing).  Emissions therefore land
    directly in frame-buffer order, making the dequant stage fully
    elementwise — no scatter and no gather.  On real DCS material this
    costs no extra scan steps (skipped-band spans are rare and the max
    position total matches the max dense total).

    Constraint shared with the dense design: a two-zero codeword never ends
    a band in a valid stream (neither the reference encoder nor ours emits
    one there), so the skip carry never has to survive a filler slot.

    Returns (packed [F,S] scan control words, scale [F,S],
             total [F] position counts).
    """
    adv = ctl["advance"]
    bounds = jnp.cumsum(adv, axis=1)
    total = bounds[:, -1]
    band_start = bounds - adv

    code_b = ctl["code"]
    is_cb_b = (code_b >= 1) & (code_b <= 6)
    maxw_b = jnp.where(is_cb_b, jnp.asarray(_MAXW)[jnp.clip(code_b, 0, 6)],
                       jnp.clip(code_b, 0, 17))
    cb_b = jnp.asarray(_CB_BASE)[jnp.clip(code_b, 0, 6)]
    # decimated (out_inc=2) bands interleave zero slots; the symbol mask
    # only needs the band's start PARITY and the inc flag, so both ride in
    # the packed word and the geometry expansion disappears entirely
    packed_b = (code_b | (maxw_b << _P_MAXW) | (cb_b << _P_CB)
                | (1 << _P_VALID)
                | ((ctl["scale_code"] & 0x3F) << _P_SCALE)
                | ((ctl["out_inc"] - 1) << _P_INC2)
                | ((band_start & 1) << _P_PAR))
    packed_b = jnp.where(code_b != 0, packed_b, 0)

    dgrid = jnp.arange(n_slots, dtype=jnp.int32).reshape(1, n_slots)
    packed = _expand(band_start, packed_b, n_slots)
    # the scale derives elementwise from the packed word (the scale value
    # depends only on the low 6 bits of the scale code) — one less
    # scatter+cumsum expansion over [F, n_slots].  Filler/invalid slots
    # (packed==0) get scale 1; their sample is 0, so scaled stays 0 and
    # the accumulate is still an exact pass-through.
    sc = (packed >> _P_SCALE) & 0x3F
    m2 = sc & 3
    mant = jnp.where(m2 == 0, 0x8000,
                     jnp.where(m2 == 1, 0x9838,
                               jnp.where(m2 == 2, 0xB505, 0xD745)))
    scale = mant >> (15 - ((sc >> 2) & 0xF))
    inc2 = (packed >> _P_INC2) & 1
    par = (packed >> _P_PAR) & 1
    on_symbol = (inc2 == 0) | ((dgrid & 1) == par)
    valid = dgrid < total[:, None]
    packed = jnp.where(valid & on_symbol, packed, 0)
    return packed, scale, total


def decode_frames94(stream_bytes, start_bit, header, fmt_type, sub_type,
                    band_type, band_type_prev, n_steps=256):
    """Decode all frames of one stream in parallel.

    stream_bytes: [L] int32 (byte values, ≥3 bytes padding); start_bit: [F];
    band_type / band_type_prev: [F, 16]; fmt_type/sub_type/n_steps static.
    n_steps must cover the maximum POSITION count over the frames (≤ 256;
    host computes it from the prescan's band types — it is data-independent;
    see ops/prescan.scan_totals).

    Returns (position-ordered values [F, 256] in u16 storage,
             (scale [F, 256], total [F])).

    Structure: the scan runs over frame-buffer positions, not symbols.
    The per-slot controls stream in as scan xs (sliced, not gathered); a
    "skip" carry bit implements the codebooks' two-zeros-per-codeword case;
    emitted values come out in frame-buffer order, so downstream dequant is
    elementwise.  The only large gather is the 128-bit row window —
    ONE row gather per FIVE symbols (window_quads/quad_extract).
    """
    ctl = band_controls(header, sub_type, fmt_type, band_type, band_type_prev)
    packed, scale, total = slot_controls(ctl)
    F = start_bit.shape[0]
    quads = window_quads(stream_bytes)
    K = symbols_per_row(quads)

    def group(carry, packed_g):            # packed_g: [K, F]
        cursor, skip = carry
        base = cursor >> 5
        quad = quads[base]                 # [F, nwords] uint32
        d = cursor & 31
        samples = []
        for k in range(K):
            packed_t = packed_g[k]
            ok = packed_t != 0
            c = packed_t & 0x1F
            mw = (packed_t >> _P_MAXW) & 0x1F
            cb = (packed_t >> _P_CB) & 0x3FF
            look = quad_extract(quad, d, mw)
            is_cb = c <= 6   # c==0 only when !ok (masked below)
            entry = cb_entry(cb + look)
            two_zero = is_cb & ((entry & 0x80) != 0)
            sample_cb = (entry & 0x7F) - (1 << jnp.clip(c - 1, 0, 14))
            # raw: sign-extend mw bits
            mw1 = jnp.maximum(mw, 1)
            sample_raw = look - ((look >> (mw1 - 1)) << mw1)
            consume = ok & ~skip
            nbits = jnp.where(is_cb, entry >> 8, mw)
            sample = jnp.where(is_cb, sample_cb, sample_raw) & M16
            sample = jnp.where(two_zero | skip | ~ok, 0, sample)
            d = d + jnp.where(consume, nbits, 0)
            skip = jnp.where(skip, False, consume & two_zero)
            samples.append(sample)
        return ((base << 5) + d, skip), jnp.stack(samples)

    cursor0 = start_bit.astype(jnp.int32)
    skip0 = jnp.zeros(F, bool)
    n_groups = -(-n_steps // K)
    S = n_groups * K
    pk = packed[:, :min(S, packed.shape[1])]
    if S > pk.shape[1]:
        pk = jnp.pad(pk, ((0, 0), (0, S - pk.shape[1])))
    xs = jnp.transpose(pk).reshape(n_groups, K, F)
    _, vals = jax.lax.scan(group, (cursor0, skip0), xs)
    dense_vals = jnp.transpose(vals.reshape(S, F))     # [F, S]
    if S < 256:
        dense_vals = jnp.pad(dense_vals, ((0, 0), (0, 256 - S)))
    else:
        dense_vals = dense_vals[:, :256]
    return dense_vals, (scale, total)


def dequant_mix(pos_vals, slot_ctl, mix, fb_prev=None, active=None):
    """Dequantize/scale position-ordered samples into frame buffers [F, 512].

    pos_vals [F, S]: decode_frames94 output — sample for fb position p+1 at
    column p (fillers are 0, which dequantizes to an exact pass-through of
    the previous accumulator value).  slot_ctl: (scale [F, S], total [F]).
    mix: [F] per-frame mixing multiplier (u16 storage).  fb_prev: prior
    accumulated frame buffers (other channels), or None for silence.
    active: [F] bool — frames where this channel actually plays.

    Because emissions are already in frame-buffer order, this stage is pure
    elementwise arithmetic — no scatter, no gather.  Implements the
    exact accumulate + first-sample delta fixup
    (reference: DCSDecoderNative.cpp:2244-2257).
    """
    with jax.named_scope("dequant_mix"):
        scale, total = slot_ctl
        F, S = pos_vals.shape
        pos = jnp.arange(S, dtype=jnp.int32).reshape(1, S)
        valid = pos < total[:, None]
        if active is not None:
            valid = valid & active[:, None]

        # a zero scaled value makes the whole update an exact pass-through of
        # the accumulator word, so masking `scaled` is the only gate needed
        scaled = (s16(pos_vals) * (scale & M16)) & M16
        scaled = jnp.where(valid, scaled, 0)
        mixprod = s16(scaled) * (mix[:, None] & M16)

        if fb_prev is None:
            outbuf1 = jnp.zeros((F,), jnp.int32)
            fb_prev = jnp.zeros((F, 512), jnp.int32)
            new_val = ((scaled + mixprod) >> 16) & M16
        else:
            outbuf1 = fb_prev[:, 1]
            out_old = fb_prev[:, 1:1 + S]
            prod = ((s16(out_old) << 16) | scaled) + mixprod
            new_val = (prod >> 16) & M16

        fb = jax.lax.dynamic_update_slice_in_dim(fb_prev, new_val, 1, axis=1)

        # first-sample delta fixup (only where the channel is active)
        delta = sat16(s16(fb[:, 1]) - s16(outbuf1))
        fb0 = sat16(s16(delta) + s16(fb[:, 0]))
        if active is not None:
            fb0 = jnp.where(active, fb0, fb[:, 0])
            fb1 = jnp.where(active, outbuf1, fb[:, 1])
        else:
            fb1 = outbuf1
        fb = fb.at[:, 0].set(fb0 & M16)
        fb = fb.at[:, 1].set(fb1)
        return fb


def dequant_mix_dense(dense_vals, slot_ctl, mix, fb_prev=None, active=None):
    """Dense-slot-order dequant (scatter formulation) — retained for the
    hybrid path, whose native C++ stage emits dense values + explicit
    frame-buffer indices (slot_ctl: (scale, fb_idx, valid)).
    Exact accumulate semantics as dequant_mix."""
    scale, fb_idx, valid = slot_ctl
    F = dense_vals.shape[0]
    if active is not None:
        valid = valid & active[:, None]

    scaled = (s16(dense_vals) * (scale & M16)) & M16
    contrib_low = scaled + 0      # low word inserted into the accumulator
    mixprod = s16(scaled) * (mix[:, None] & M16)

    if fb_prev is None:
        # out_old = 0 everywhere: prod = scaled | 0<<16, + mixprod
        new_val = ((contrib_low + mixprod) >> 16) & M16
        outbuf1 = jnp.zeros((F,), jnp.int32)
        fb_prev = jnp.zeros((F, 512), jnp.int32)
    else:
        outbuf1 = fb_prev[:, 1]
        out_old = jnp.take_along_axis(fb_prev, jnp.clip(fb_idx, 0, 511), axis=1)
        prod = ((s16(out_old) << 16) | contrib_low) + mixprod
        new_val = (prod >> 16) & M16

    # scatter-free placement (see ops/decode93.py): positions are written
    # at most once per frame, so a fused one-hot reduce places exactly
    tgt = jnp.where(valid, fb_idx, 512)[:, :, None]
    hit = tgt == jnp.arange(512, dtype=jnp.int32).reshape(1, 1, 512)
    sums = jnp.sum(jnp.where(hit, new_val[:, :, None], 0), axis=1)
    fb = jnp.where(jnp.any(hit, axis=1), sums, fb_prev)

    # first-sample delta fixup (only where the channel is active)
    delta = sat16(s16(fb[:, 1]) - s16(outbuf1))
    fb0 = sat16(s16(delta) + s16(fb[:, 0]))
    if active is not None:
        fb0 = jnp.where(active, fb0, fb[:, 0])
        fb1 = jnp.where(active, outbuf1, fb[:, 1])
    else:
        fb1 = outbuf1
    fb = fb.at[:, 0].set(fb0)
    fb = fb.at[:, 1].set(fb1)
    return fb
