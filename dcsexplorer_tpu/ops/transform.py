"""Batched inverse frequency transform (device path).

Vectorized, bit-exact JAX implementation of the two DCS inverse-RDFT
algorithms over a batch of frames: input frame buffers [B, 512] (u16-in-int32
storage), per-frame volume shifts [B], carried overlap buffers [B, 16];
outputs 240 PCM words per frame plus the next overlap buffer.

The scalar semantics being vectorized are in ``refdec/transform.py``
(reference anchors: DCSDecoderNative.cpp:397-576 and :614-813).  All loops are
static; every iteration's read/write sets are disjoint (or provably
consistent), so each pass vectorizes into pure gather/compute/scatter over the
batch — XLA fuses the elementwise chains, and the batch dimension is the
vector axis.
"""

import numpy as np

import jax.numpy as jnp

from ..format import tables as T
from .fixmath import M16, mulss, overlap_mix, rotate_round, s16, sat16

_BR = np.asarray(T.BITREV9, dtype=np.int32)
_IFFT = np.asarray(T.IFFT_COEFF, dtype=np.int32)
_SIN = _IFFT[:128]
_COS = _IFFT[128:]
_OVL = np.asarray(T.OVERLAP_COEFF, dtype=np.int32)

# pre-pass pair index maps (see refdec/transform.py for the walk structure)
_P1_X = np.arange(0, 128, dtype=np.int32)                       # p0 side, pairs (2i,2i+1)
_P1_Y = np.empty(128, dtype=np.int32)                           # p1 side, descending pairs
for _i in range(64):
    _P1_Y[2 * _i] = 0x100 - 2 * _i
    _P1_Y[2 * _i + 1] = 0x101 - 2 * _i

# pre-pass 2 coefficient banks: c0 = IFFT[br[2+4i]], c1 = IFFT[br[4i]]
_P2_C0 = _IFFT[_BR[2 + 4 * np.arange(64)]]
_P2_C1 = _IFFT[_BR[4 * np.arange(64)]]

# overlap-add positions: outputs 0..15 live at br[0],br[0]+1,br[2],br[2]+1,...
_OVL_POS = np.empty(16, dtype=np.int32)
for _k in range(16):
    _OVL_POS[_k] = _BR[2 * (_k // 2)] + (_k % 2)
_OVL_NEW = _OVL.copy()            # coefficient applied to the new frame value
_OVL_OLD = _OVL[::-1].copy()      # coefficient applied to the carried value

# output extraction and overlap-save index maps
_EXTRACT = np.empty(240, dtype=np.int32)
for _i in range(0, 240, 2):
    _EXTRACT[_i] = _BR[_i]
    _EXTRACT[_i + 1] = _BR[_i] + 1
_SAVE = np.empty(16, dtype=np.int32)
for _j, _i in enumerate(range(240, 256, 2)):
    _SAVE[2 * _j] = _BR[_i]
    _SAVE[2 * _j + 1] = _BR[_i] + 1

# 1993 algorithm: bit-reversed sources for the volume/extraction pass
_BR93_SRC = _BR[:256].copy()      # all even values (bit 8 of i is 0)


def _round_sub(p_a, p_b):
    """round(p_a_chain - p_b_chain) per MulSS+MultiplyRoundSub; products are
    pre-shift (a*b) int32 values; quirk keyed on (p_b<<1) low word."""
    mr = ((p_a - p_b) << 1) + 0x8000
    mr = jnp.where(((p_b << 1) & M16) == 0x8000, mr & ~0x10000, mr)
    return s16(mr >> 16)


def _round_add(p_a, p_b):
    mr = ((p_a + p_b) << 1) + 0x8000
    mr = jnp.where(((p_b << 1) & M16) == 0x8000, mr & ~0x10000, mr)
    return s16(mr >> 16)


def transform94(fb, overlap, vol_shift):
    """1994+ inverse transform, batched.

    fb: [B, 512] u16 storage; overlap: [B, 16]; vol_shift: [B] int32.
    Returns (pcm [B, 240] u16 storage, new_overlap [B, 16]).
    """
    B = fb.shape[0]
    vs = vol_shift.reshape(B, 1)

    # center-element fixups
    fb = fb.at[:, 0x80].set(mulss(fb[:, 0x80], 0x8000))
    fb = fb.at[:, 0x81].set(mulss((-s16(fb[:, 0x81])) & M16, 0x8000))

    # pre-pass 1: fold ends through ±sums, then negate via ×$8000
    x = fb[:, _P1_X]
    y = fb[:, _P1_Y]
    x0, x1 = s16(x[:, 0::2]), s16(x[:, 1::2])
    y0, y1 = s16(y[:, 0::2]), s16(y[:, 1::2])
    n_x0 = mulss(sat16(x0 + y0), 0x8000)
    n_y0 = mulss(sat16(x0 - y0), 0x8000)
    n_x1 = mulss(sat16(x1 - y1), 0x8000)
    n_y1 = mulss(sat16(x1 + y1), 0x8000)
    xi = jnp.stack([n_x0, n_x1], axis=-1).reshape(B, 128)
    yi = jnp.stack([n_y0, n_y1], axis=-1).reshape(B, 128)
    fb = fb.at[:, _P1_X].set(xi).at[:, _P1_Y].set(yi)

    # pre-pass 2: complex twiddle fold with rounding
    x = fb[:, _P1_X]
    y = fb[:, _P1_Y]
    x0, x1 = s16(x[:, 0::2]), s16(x[:, 1::2])
    yn0, yn1 = s16(y[:, 0::2]), s16(y[:, 1::2])
    c0 = jnp.asarray(_P2_C0)[None, :]
    c1 = jnp.asarray(_P2_C1)[None, :]
    prod0 = _round_sub(yn1 * s16(c1), yn0 * s16(c0))
    prod1 = _round_add(yn1 * s16(c0), yn0 * s16(c1))
    n_x0 = sat16(prod1 + x0)
    n_x1 = sat16(prod0 + x1)
    n_y0 = sat16(x0 - prod1)
    n_y1 = sat16(prod0 - x1)
    xi = jnp.stack([n_x0, n_x1], axis=-1).reshape(B, 128)
    yi = jnp.stack([n_y0, n_y1], axis=-1).reshape(B, 128)
    fb = fb.at[:, _P1_X].set(xi).at[:, _P1_Y].set(yi)

    # pre-pass 3: butterfly halves
    x = s16(fb[:, 0:128])
    y = s16(fb[:, 128:256])
    fb = fb.at[:, 0:128].set(sat16(x + y)).at[:, 128:256].set(sat16(x - y))

    # 6-iteration in-place IFFT over the first 256 entries
    core = fb[:, :256]
    n_part, part_size = 2, 0x40
    for _ in range(6):
        v = core.reshape(B, n_part, 2, part_size)
        u, a = v[:, :, 0, :], v[:, :, 1, :]
        ap = a.reshape(B, n_part, part_size // 2, 2)
        a_re, a_im = ap[..., 0], ap[..., 1]
        c_cos = jnp.asarray(_COS[:n_part]).reshape(1, n_part, 1)
        c_sin = jnp.asarray(_SIN[:n_part]).reshape(1, n_part, 1)
        t_re, t_im = rotate_round(a_re, a_im, c_cos, c_sin)
        up = u.reshape(B, n_part, part_size // 2, 2)
        u_re, u_im = s16(up[..., 0]), s16(up[..., 1])
        nu = jnp.stack([sat16(u_re - t_re), sat16(u_im - t_im)], axis=-1)
        na = jnp.stack([sat16(u_re + t_re), sat16(u_im + t_im)], axis=-1)
        core = jnp.stack([nu.reshape(B, n_part, part_size),
                          na.reshape(B, n_part, part_size)], axis=2
                         ).reshape(B, 256)
        n_part *= 2
        part_size //= 2

    # volume normalization
    core = (s16(core) >> vs) & M16
    fb = fb.at[:, :256].set(core)

    # overlap-add into the first 16 outputs
    cur = fb[:, _OVL_POS]
    blended = overlap_mix(cur, overlap,
                          jnp.asarray(_OVL_NEW)[None, :],
                          jnp.asarray(_OVL_OLD)[None, :])
    fb = fb.at[:, _OVL_POS].set(blended)

    # bit-reversed extraction + overlap save
    pcm = fb[:, _EXTRACT]
    new_overlap = fb[:, _SAVE]
    return pcm, new_overlap


def transform94_raw(fb, vol_shift):
    """The overlap-free part of transform94: everything up to and including
    volume normalization, returning the 256 time-domain words per frame in
    bit-reversed storage order [B, 512-view trimmed to 256].

    Used by the batched pipeline, which resolves overlap-add across the frame
    axis as a pure shift (frame f's carried buffer = frame f-1's last 16
    outputs), avoiding any scan.
    """
    B = fb.shape[0]
    vs = vol_shift.reshape(B, 1)

    fb = fb.at[:, 0x80].set(mulss(fb[:, 0x80], 0x8000))
    fb = fb.at[:, 0x81].set(mulss((-s16(fb[:, 0x81])) & M16, 0x8000))

    x = fb[:, _P1_X]
    y = fb[:, _P1_Y]
    x0, x1 = s16(x[:, 0::2]), s16(x[:, 1::2])
    y0, y1 = s16(y[:, 0::2]), s16(y[:, 1::2])
    n_x0 = mulss(sat16(x0 + y0), 0x8000)
    n_y0 = mulss(sat16(x0 - y0), 0x8000)
    n_x1 = mulss(sat16(x1 - y1), 0x8000)
    n_y1 = mulss(sat16(x1 + y1), 0x8000)
    xi = jnp.stack([n_x0, n_x1], axis=-1).reshape(B, 128)
    yi = jnp.stack([n_y0, n_y1], axis=-1).reshape(B, 128)
    fb = fb.at[:, _P1_X].set(xi).at[:, _P1_Y].set(yi)

    x = fb[:, _P1_X]
    y = fb[:, _P1_Y]
    x0, x1 = s16(x[:, 0::2]), s16(x[:, 1::2])
    yn0, yn1 = s16(y[:, 0::2]), s16(y[:, 1::2])
    c0 = jnp.asarray(_P2_C0)[None, :]
    c1 = jnp.asarray(_P2_C1)[None, :]
    prod0 = _round_sub(yn1 * s16(c1), yn0 * s16(c0))
    prod1 = _round_add(yn1 * s16(c0), yn0 * s16(c1))
    xi = jnp.stack([sat16(prod1 + x0), sat16(prod0 + x1)], axis=-1).reshape(B, 128)
    yi = jnp.stack([sat16(x0 - prod1), sat16(prod0 - x1)], axis=-1).reshape(B, 128)
    fb = fb.at[:, _P1_X].set(xi).at[:, _P1_Y].set(yi)

    x = s16(fb[:, 0:128])
    y = s16(fb[:, 128:256])
    core = jnp.concatenate([sat16(x + y), sat16(x - y)], axis=1)

    n_part, part_size = 2, 0x40
    for _ in range(6):
        v = core.reshape(B, n_part, 2, part_size)
        u, a = v[:, :, 0, :], v[:, :, 1, :]
        ap = a.reshape(B, n_part, part_size // 2, 2)
        a_re, a_im = ap[..., 0], ap[..., 1]
        c_cos = jnp.asarray(_COS[:n_part]).reshape(1, n_part, 1)
        c_sin = jnp.asarray(_SIN[:n_part]).reshape(1, n_part, 1)
        t_re, t_im = rotate_round(a_re, a_im, c_cos, c_sin)
        up = u.reshape(B, n_part, part_size // 2, 2)
        u_re, u_im = s16(up[..., 0]), s16(up[..., 1])
        nu = jnp.stack([sat16(u_re - t_re), sat16(u_im - t_im)], axis=-1)
        na = jnp.stack([sat16(u_re + t_re), sat16(u_im + t_im)], axis=-1)
        core = jnp.stack([nu.reshape(B, n_part, part_size),
                          na.reshape(B, n_part, part_size)], axis=2
                         ).reshape(B, 256)
        n_part *= 2
        part_size //= 2

    return (s16(core) >> vs) & M16


# ----------------------------------------------------------------------
# planar (split re/im) 94 transform — the fast path
#
# The interleaved stack/reshape dance in transform94_raw is pure data
# movement, most of the six IFFT iterations' cost (the butterfly math
# is a small part).  Storing the complex pairs as two PLANES (re[k] = core[2k],
# im[k] = core[2k+1]) makes every iteration's u/a split a CONTIGUOUS
# halving and every write a concatenation: zero lane shuffles in the whole
# iteration phase.  The only gathers left are the initial descending y-pair
# gather (which transform94_raw also pays, inside fb[:, _P1_Y]) and the
# final bit-reversed extraction (which the caller already pays).  Bit-exact
# with transform94_raw by construction and by test.

_P1_Y0 = _P1_Y[0::2].copy()       # descending even positions 0x100-2i
_P1_Y1 = _P1_Y[1::2].copy()       # descending odd positions 0x101-2i

# planar composition of the caller-side index maps: every map pairs an even
# position 2k with 2k+1, so the planar maps address plane index k
assert np.all(_EXTRACT[0::2] % 2 == 0) and np.all(
    _EXTRACT[1::2] == _EXTRACT[0::2] + 1)
assert np.all(_OVL_POS[1::2] == _OVL_POS[0::2] + 1)
assert np.all(_SAVE[1::2] == _SAVE[0::2] + 1)
_EXT_HALF = (_EXTRACT[0::2] >> 1).copy()      # [120]
_OVL_HALF = (_OVL_POS[0::2] >> 1).copy()      # [8]
_SAVE_HALF = (_SAVE[0::2] >> 1).copy()        # [8]
assert np.all(_EXT_HALF[:8] == _OVL_HALF)     # outputs 0..15 lead the extract


def transform94_planar(fb, vol_shift):
    """1994+ inverse transform in planar layout; bit-exact with
    transform94_raw (re[k] = raw[2k], im[k] = raw[2k+1]).

    fb: [B, 512] u16 storage; vol_shift: [B].
    Returns (re [B, 128], im [B, 128]) volume-normalized time-domain words
    in bit-reversed storage order.
    """
    B = fb.shape[0]

    # center fixups: positions 0x80/0x81 are read only by pre-pass 3
    fb128 = mulss(fb[:, 0x80], 0x8000)
    fb129 = mulss((-s16(fb[:, 0x81])) & M16, 0x8000)

    x0 = s16(fb[:, 0:128:2])
    x1 = s16(fb[:, 1:128:2])
    y0 = s16(fb[:, _P1_Y0])
    y1 = s16(fb[:, _P1_Y1])

    # pre-pass 1: fold ends through ±sums, then negate via ×$8000
    n_x0 = s16(mulss(sat16(x0 + y0), 0x8000))
    n_y0 = s16(mulss(sat16(x0 - y0), 0x8000))
    n_x1 = s16(mulss(sat16(x1 - y1), 0x8000))
    n_y1 = s16(mulss(sat16(x1 + y1), 0x8000))

    # pre-pass 2: complex twiddle fold (planes chain directly — the
    # interleaved rematerialization between the passes was pure movement)
    c0 = jnp.asarray(_P2_C0)[None, :]
    c1 = jnp.asarray(_P2_C1)[None, :]
    prod0 = _round_sub(n_y1 * s16(c1), n_y0 * s16(c0))
    prod1 = _round_add(n_y1 * s16(c0), n_y0 * s16(c1))
    fx0 = s16(sat16(prod1 + n_x0))
    fx1 = s16(sat16(prod0 + n_x1))
    fy0 = sat16(n_x0 - prod1)         # descending order, like y0
    fy1 = sat16(prod0 - n_x1)

    # pre-pass 3: x[q] ± y[128+q].  y[128] / y[129] are the untouched
    # center fixups; y[130..255] are the y planes read back in ASCENDING
    # position order (one flip), dropping the dead 0x100/0x101 pair.
    yA = s16(jnp.concatenate(
        [fb128[:, None], jnp.flip(fy0, axis=1)[:, :63]], axis=1))
    yB = s16(jnp.concatenate(
        [fb129[:, None], jnp.flip(fy1, axis=1)[:, :63]], axis=1))
    re = jnp.concatenate([sat16(fx0 + yA), sat16(fx0 - yA)], axis=1)
    im = jnp.concatenate([sat16(fx1 + yB), sat16(fx1 - yB)], axis=1)

    # 6-iteration IFFT: planar groups split/concat CONTIGUOUSLY
    n_part, part = 2, 0x40
    for _ in range(6):
        r = re.reshape(B, n_part, part)
        i_ = im.reshape(B, n_part, part)
        h = part // 2
        u_re, a_re = r[:, :, :h], r[:, :, h:]
        u_im, a_im = i_[:, :, :h], i_[:, :, h:]
        c_cos = jnp.asarray(_COS[:n_part]).reshape(1, n_part, 1)
        c_sin = jnp.asarray(_SIN[:n_part]).reshape(1, n_part, 1)
        t_re, t_im = rotate_round(a_re, a_im, c_cos, c_sin)
        ur, ui = s16(u_re), s16(u_im)
        re = jnp.concatenate([sat16(ur - t_re), sat16(ur + t_re)],
                             axis=2).reshape(B, 128)
        im = jnp.concatenate([sat16(ui - t_im), sat16(ui + t_im)],
                             axis=2).reshape(B, 128)
        n_part *= 2
        part //= 2

    vs = vol_shift.reshape(B, 1)
    return (s16(re) >> vs) & M16, (s16(im) >> vs) & M16


def overlap_resolve_planar(re, im, stream_start):
    """Flat-axis overlap resolve + bit-reversed extraction, planar inputs.

    re/im: [F, 128] planar output of transform94_planar for F flat frames;
    stream_start: [F] bool (overlap carry resets there).
    Returns pcm [F, 240] u16 storage — identical to resolving with
    overlap_resolve on the interleaved raw.
    """
    heads_re = re[:, _OVL_HALF]
    heads_im = im[:, _OVL_HALF]
    tails_re = re[:, _SAVE_HALF]
    tails_im = im[:, _SAVE_HALF]
    z = jnp.zeros((1, 8), jnp.int32)
    carried_re = jnp.where(stream_start[:, None], 0,
                           jnp.concatenate([z, tails_re[:-1]], axis=0))
    carried_im = jnp.where(stream_start[:, None], 0,
                           jnp.concatenate([z, tails_im[:-1]], axis=0))
    cn = jnp.asarray(_OVL_NEW)
    co = jnp.asarray(_OVL_OLD)
    blended_re = overlap_mix(heads_re, carried_re, cn[None, 0::2],
                             co[None, 0::2])
    blended_im = overlap_mix(heads_im, carried_im, cn[None, 1::2],
                             co[None, 1::2])
    ext_re = re[:, _EXT_HALF].at[:, :8].set(blended_re)
    ext_im = im[:, _EXT_HALF].at[:, :8].set(blended_im)
    return jnp.stack([ext_re, ext_im], axis=-1).reshape(re.shape[0], 240)


def overlap_resolve_planar_state(re, im, overlap0):
    """Planar counterpart of overlap_resolve: carried overlap0 in, final
    overlap out (both in the interleaved 16-slot order of the state
    contract, so snapshots stay interchangeable).

    re/im: [F, 128] planar transform output for F consecutive frames of ONE
    stream; overlap0: [16].  Returns (pcm [F, 240], final overlap [16]).
    """
    heads_re = re[:, _OVL_HALF]
    heads_im = im[:, _OVL_HALF]
    tails_re = re[:, _SAVE_HALF]
    tails_im = im[:, _SAVE_HALF]
    carried_re = jnp.concatenate([overlap0[None, 0::2], tails_re[:-1]], axis=0)
    carried_im = jnp.concatenate([overlap0[None, 1::2], tails_im[:-1]], axis=0)
    cn = jnp.asarray(_OVL_NEW)
    co = jnp.asarray(_OVL_OLD)
    blended_re = overlap_mix(heads_re, carried_re, cn[None, 0::2],
                             co[None, 0::2])
    blended_im = overlap_mix(heads_im, carried_im, cn[None, 1::2],
                             co[None, 1::2])
    ext_re = re[:, _EXT_HALF].at[:, :8].set(blended_re)
    ext_im = im[:, _EXT_HALF].at[:, :8].set(blended_im)
    pcm = jnp.stack([ext_re, ext_im], axis=-1).reshape(re.shape[0], 240)
    last_ov = jnp.stack([tails_re[-1], tails_im[-1]], axis=-1).reshape(16)
    return pcm, last_ov


def overlap_resolve(raw, overlap0):
    """Resolve overlap-add across the frame axis without a scan.

    raw: [F, 256] volume-normalized time-domain words in bit-reversed storage
    (output of transform94_raw for F consecutive frames of ONE stream);
    overlap0: [16] initial carried buffer.  Returns (pcm [F, 240], final
    overlap [16]).
    """
    heads = raw[:, _OVL_POS]            # [F, 16] new-frame contributions
    tails = raw[:, _SAVE]               # [F, 16] each frame's carry-out
    carried = jnp.concatenate([overlap0[None, :], tails[:-1]], axis=0)
    blended = overlap_mix(heads, carried,
                          jnp.asarray(_OVL_NEW)[None, :],
                          jnp.asarray(_OVL_OLD)[None, :])
    fixed = raw.at[:, _OVL_POS].set(blended)
    return fixed[:, _EXTRACT], tails[-1]


# ----------------------------------------------------------------------
# 1993 algorithm (batched)

def _taylor_sqrt93(fb0, fb1):
    """Vectorized magnitude fixup of element 0 (reference :633-704).

    fb0, fb1: [B] u16 storage.  Returns the replacement value for slot 0.
    """
    from .fixmath import s16 as _s16

    ar = _s16(fb0)
    as_flag = ar < 0
    ar = jnp.where(as_flag, -ar, ar) & M16

    # mr = fb1² + ar² in the <<1 accumulator domain
    p1 = s16(fb1) * s16(fb1)
    p2 = s16(ar) * s16(ar)
    mr = (p1 + p2) << 1

    # normalize32 over the low 32 bits (mr is already int32-wrapped)
    v = mr
    neg = v < 0
    x = jnp.where(neg, ~v, v)            # leading-zero count domain
    # exponent = -(clz(x<<1)) clipped; compute clz via float trick-free loop
    exp = jnp.zeros_like(v)
    xx = v
    for _ in range(31):
        more = jnp.where(
            xx < 0,
            (xx & 0x40000000) != 0,
            (exp > -31) & ((xx & 0x40000000) == 0))
        exp = jnp.where(more, exp - 1, exp)
        xx = jnp.where(more, xx << 1, xx)
    mant = jnp.where(exp <= -32, 0,
                     jnp.where(exp < 0, (v << (-exp)), v))
    ar2 = (mant >> 16) & M16
    exponent = exp

    def mul_round(a, b):
        prod = (s16(a) * s16(b)) << 1
        res = prod + 0x8000
        res = jnp.where((prod & M16) == 0x8000, res & ~0x10000, res)
        return (res >> 16) & M16, res

    # 5-term Taylor series in the accumulator
    mr = jnp.full_like(v, 0x0D490000)
    mr = mr + ((0x5D1D * s16(ar2)) << 1)
    mf, _ = mul_round(ar2, ar2)
    mr = mr + ((-22035 * s16(mf)) << 1)
    mf, _ = mul_round(ar2, mf)
    mr = mr + ((0x46D6 * s16(mf)) << 1)
    mf, _ = mul_round(ar2, mf)
    mr = mr + ((-8790 * s16(mf)) << 1)
    mf, _ = mul_round(ar2, mf)
    mr = mr + ((0x072D * s16(mf)) << 1)

    odd = (exponent & 1) != 0
    # MultiplyAndRound(MR1(mr), 0x5A82) replaces mr where exponent is odd
    mr1v = (mr >> 16) & M16
    prod = (s16(mr1v) * 0x5A82) << 1
    res = prod + 0x8000
    res = jnp.where((prod & M16) == 0x8000, res & ~0x10000, res)
    mr = jnp.where(odd, res, mr)
    exponent = jnp.where(odd, exponent + 1, exponent)

    exponent = exponent // 2 + 1      # even values: trunc == floor
    # BitShiftSigned32 of the low 32 bits of mr by `exponent`
    low = mr.astype(jnp.int32)
    shifted = jnp.where(exponent >= 0,
                        (low << jnp.clip(exponent, 0, 31)),
                        low >> jnp.clip(-exponent, 0, 31))
    arf = (shifted >> 16) & M16
    arf = jnp.where(as_flag, (-s16(arf)) & M16, arf)
    # AR==0 skips the series and stores the (zero) normalized mantissa
    return jnp.where(ar2 == 0, ar2, arf)


# expansion pair index maps (reference :713-732)
_E93_I0 = 2 + 2 * np.arange(64)
_E93_I1 = 0xFE - 2 * np.arange(64)
_E93_I2 = 0x102 + 2 * np.arange(64)
_E93_I3 = 0x1FE - 2 * np.arange(64)

# extraction sources: odd slots 1,3,..511 get fb[bitRev9[0..255]] >> volShift
_BR93 = _BR[:256]


# the 93 extraction only touches EVEN storage positions (bit 8 of the
# bit-reversed index is 0 for i < 256), i.e. the re plane
assert np.all(_BR93_SRC % 2 == 0)
_BR93_HALF = (_BR93_SRC >> 1).copy()


def transform93_raw(fb, vol_shift):
    """1993 inverse transform, batched; returns per-frame time words.

    fb: [B, 512] u16 storage; vol_shift: [B].
    Returns raw [B, 256]: time samples in natural order — outputs 0..239
    then the 16-sample overlap tail (pre-blend), volume-shifted.

    Internally planar (re[k] = fb[2k], im[k] = fb[2k+1]) like
    transform94_planar: the expansion pass and all seven IFFT iterations
    run on contiguous plane slices with zero interleave shuffles; the final
    bit-reversed collection reads only the re plane (asserted above), so
    the output gather is unchanged.  Bit-exact with the interleaved
    formulation (tests/test_transform_ops.py, tests/test_format93.py).
    """
    B = fb.shape[0]

    ar = _taylor_sqrt93(fb[:, 0], fb[:, 1])

    # planar view; apply the center fixups in-plane
    re0 = fb[:, 0::2]
    im0 = fb[:, 1::2]

    # expand 256 → 512.  Reads (pre-fixup planes + fixed slots):
    #   xr = fb[2+2i]   = re[1+i],  i = 0..63
    #   xi = fb[3+2i]   = im[1+i]
    #   yr = fb[0xFE-2i] = re[127-i]   (flip of re[64:128])
    #   yi = fb[0xFF-2i] = im[127-i]
    xr = s16(re0[:, 1:65])
    xi = s16(im0[:, 1:65])
    yr = s16(jnp.flip(re0[:, 64:128], axis=1))
    yi = s16(jnp.flip(im0[:, 64:128], axis=1))

    add_r = (xr + yr) & M16
    sub_r = (xr - yr) & M16
    bus_r = (yr - xr) & M16
    add_i = (xi + yi) & M16
    sub_i = (xi - yi) & M16
    bus_i = (yi - xi) & M16

    # writes, replicating the reference's overlap order (the later write
    # wins at the two collision slots: re idx 192 takes yr-xr, im idx 64
    # takes yi-xi):
    arc = ar[:, None]
    z1 = jnp.zeros((B, 1), jnp.int32)
    re = jnp.concatenate(
        [arc, add_r, jnp.flip(add_r, axis=1)[:, 1:],            # 0, 1..127
         arc, sub_r[:, :63], jnp.flip(bus_r, axis=1)], axis=1)  # 128..255
    im = jnp.concatenate(
        [z1, sub_i[:, :63], jnp.flip(bus_i, axis=1),            # 0, 1..127
         z1, add_i, jnp.flip(add_i, axis=1)[:, 1:]], axis=1)    # 128..255

    # 7-iteration IFFT (planar, unsaturated wrap arithmetic)
    n_part, part = 2, 0x80
    for _ in range(7):
        r = re.reshape(B, n_part, part)
        i_ = im.reshape(B, n_part, part)
        h = part // 2
        u_re, a_re = r[:, :, :h], r[:, :, h:]
        u_im, a_im = i_[:, :, :h], i_[:, :, h:]
        c_cos = jnp.asarray(_COS[:n_part]).reshape(1, n_part, 1)
        c_sin = jnp.asarray(_SIN[:n_part]).reshape(1, n_part, 1)
        t_re, t_im = rotate_round(a_re, a_im, c_cos, c_sin)
        ur, ui = s16(u_re), s16(u_im)
        re = jnp.concatenate([(ur - t_re) & M16, (ur + t_re) & M16],
                             axis=2).reshape(B, 256)
        im = jnp.concatenate([(ui - t_im) & M16, (ui + t_im) & M16],
                             axis=2).reshape(B, 256)
        n_part *= 2
        part //= 2

    # volume shift + bit-reversed collection in natural time order
    vs = vol_shift.reshape(B, 1)
    return (s16(re[:, _BR93_HALF]) >> vs) & M16


def overlap_resolve93_flat(raw, stream_start):
    """Flat-axis overlap resolve for the 93 transform's natural-order
    output: like overlap_resolve93, but the carried tail ZEROES at each
    stream's first frame, so frames of many concatenated streams resolve
    in one pass (the 93 counterpart of overlap_resolve_planar).

    raw: [F, 256]; stream_start: [F] bool.  Returns pcm [F, 240] u16
    storage — identical to resolving each stream separately with
    overlap_resolve93(overlap0=0).
    """
    heads = raw[:, :16]
    tails = raw[:, 240:]
    z = jnp.zeros((1, 16), jnp.int32)
    carried = jnp.where(stream_start[:, None], 0,
                        jnp.concatenate([z, tails[:-1]], axis=0))
    blended = overlap_mix(heads, carried,
                          jnp.asarray(_OVL)[None, :],
                          jnp.asarray(_OVL[::-1].copy())[None, :])
    return jnp.concatenate([blended, raw[:, 16:240]], axis=1)


def overlap_resolve93(raw, overlap0):
    """Overlap-add resolve for the 93 transform's natural-order output.

    raw: [F, 256] (time order; last 16 are the carry-out tail);
    overlap0: [16].  Returns (pcm [F, 240], final overlap [16]).
    """
    heads = raw[:, :16]
    tails = raw[:, 240:]
    carried = jnp.concatenate([overlap0[None, :], tails[:-1]], axis=0)
    blended = overlap_mix(heads, carried,
                          jnp.asarray(_OVL)[None, :],
                          jnp.asarray(_OVL[::-1].copy())[None, :])
    return jnp.concatenate([blended, raw[:, 16:240]], axis=1), tails[-1]
