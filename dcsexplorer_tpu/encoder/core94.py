"""Integer-canonical decision core for the 1994+ stream encoder.

Round-3 redesign: every encoding decision (band cutoff, header scale codes,
per-band code search, the sequential band-type scan, symbol emission) is
defined over *integer* quantities derived from integer-rounded analysis
coefficients.  Integer arithmetic is exactly portable, so the vectorized
numpy implementation here and the batched JAX implementation in
``device94.py`` produce byte-identical streams from the same coefficients —
on any backend, at any batch size.  (Reference anchor for the decision
semantics: DCSEncoder.cpp:743-956 band cutoff / bit allocation,
:1502-1621 FindBestBandEncoding, :784-853 format search.)

Since round 4 the analysis itself is integer-canonical too: the window-
folded analysis matrix is quantized once to int16 and the coefficients are
DEFINED as an exact integer expression over raw int16 frames
(encoder.analyze_frames_canonical — float64 BLAS on host, int8-plane
integer matmuls on device, bit-identical), so there is no non-integer seam left
anywhere in the encode path.

Code selection: the band-type code is the smallest candidate whose width
represents the band's quantized range without wrap (see
decision_tables_np) — quantization error is non-decreasing in the code
for this grammar, so the range test IS the error minimization, and the
decision needs only each band's min/max, not a per-sample error sweep.
"""

from dataclasses import dataclass, field

import numpy as np

from ..format import tables as T

FRAME = 240
RATE = 31250

BAND_SIZES = np.asarray(T.BAND_OUTPUT_COUNT)              # [16], sums to 255
BAND_START = np.concatenate([[0], np.cumsum(BAND_SIZES)])[:16]
NBANDS = 16
NPAD = 32                                                  # padded band width

_SCALE_MANT = np.asarray(T.SCALE_MANTISSA)
_BAND_SHARE = np.asarray([16, 14, 12, 10, 9, 8, 6, 5, 4, 4, 3, 3, 3, 3, 2, 2])

# stream-format candidates in reference search order (DCSEncoder.cpp:784-853)
FORMATS = ((0, 0), (0, 3), (1, 0), (1, 3))


def _scale_factor(code):
    """Decoder scale-factor rule incl. 6-bit wrap semantics
    (DCSDecoderNative.cpp:1978-1979)."""
    return max(int(_SCALE_MANT[code & 3]) >> (15 - ((code >> 2) & 0xF)), 1)


_SCALE64 = np.asarray([_scale_factor(j) for j in range(64)])
# _scale_factor over any int code (vectorized; wraps at 64 like the decoder)
_SCALEANY = _SCALE64

_XLATS = [np.asarray(T.XLAT02), np.asarray(T.XLAT35), np.asarray(T.XLAT6F)]


def _xlat_for(band):
    return _XLATS[0 if band < 3 else 1 if band < 6 else 2]


def rdiv(a, s):
    """Round-half-away-from-zero integer division (the canonical
    quantizer): q = floor((2|a| + s) / 2s), signed.

    |a| ≤ 2^20 and s < 2^16, so every intermediate integer is < 2^24 and
    exactly representable in float32; the f32 division's floor is off by
    at most 1 and r = x − q·y is computed exactly (the true product is an
    integer < 2^24), so one fixup round makes q the exact floor — which
    makes the formula portable bit-for-bit to the device (device94 uses
    the identical f32 formula).  Hardware integer division would be exact
    too but is an order of magnitude slower in numpy."""
    a = np.asarray(a)
    x = 2.0 * np.abs(a, dtype=np.float32) + np.asarray(s, np.float32)
    y = np.float32(2.0) * np.asarray(s, dtype=np.float32)
    q = np.floor(x / y)
    r = x - q * y
    q += (r >= y).astype(np.float32) - (r < 0).astype(np.float32)
    return np.where(a < 0, -q, q).astype(np.int32)


# ----------------------------------------------------------------------
# codeword LUTs inverted from the decode tables (shared with device94)

def _invert_codebooks():
    lut_code = np.zeros((7, 64), dtype=np.int32)
    lut_bits = np.zeros((7, 64), dtype=np.int32)
    tz_code = np.zeros(7, dtype=np.int32)
    tz_bits = np.zeros(7, dtype=np.int32)
    for k in range(1, 7):
        flat = np.asarray(T.CODEBOOKS[k])
        maxw = int(T.MAX_BIT_WIDTH[k])
        seen = set()
        for i, e in enumerate(flat):
            e = int(e)
            ln, val = e >> 8, e & 0xFF
            if val & 0x80:
                if tz_bits[k] == 0:
                    tz_code[k], tz_bits[k] = i >> (maxw - ln), ln
            elif (val & 0x7F) not in seen:
                seen.add(val & 0x7F)
                lut_code[k, val & 0x7F] = i >> (maxw - ln)
                lut_bits[k, val & 0x7F] = ln
    return lut_code, lut_bits, tz_code, tz_bits


CB_CODE, CB_BITS, TZ_CODE, TZ_BITS = _invert_codebooks()


def _bits_steps():
    """Codeword lengths as step functions of the stored value.

    For codebook k the length array over the valid values [0, 2^k) is
    piecewise constant with ~a dozen plateaus (short codes cluster around
    the reference value), so bits(v) = b0 + Σ_j d_j·[v ≥ t_j] — a dozen
    compares instead of a 64-way table lookup.  This is what lets the
    device twin compute exact per-format stream sizes without any
    per-sample gather (device94._encode_format)."""
    steps = []
    for k in range(7):
        if k == 0:
            steps.append((0, [], []))
            continue
        arr = CB_BITS[k, :1 << k]
        b0 = int(arr[0])
        ts, ds = [], []
        for v in range(1, 1 << k):
            if arr[v] != arr[v - 1]:
                ts.append(v)
                ds.append(int(arr[v]) - int(arr[v - 1]))
        steps.append((b0, ts, ds))
    jmax = max(len(t) for (_, t, _) in steps)
    b0s = np.asarray([s[0] for s in steps], dtype=np.int32)
    t_tab = np.full((7, jmax), 64, dtype=np.int32)     # 64 = never reached
    d_tab = np.zeros((7, jmax), dtype=np.int32)
    for k, (_, ts, ds) in enumerate(steps):
        t_tab[k, :len(ts)] = ts
        d_tab[k, :len(ds)] = ds
    return b0s, t_tab, d_tab


BITS_B0, BITS_T, BITS_D = _bits_steps()


def _invert_delta_tree():
    tree = np.asarray(T.HUFFTREE94)
    codes = {}

    def walk(node, bits, nbits):
        for b in (0, 1):
            nxt = node + (int(tree[node]) if b else 1)
            v = int(tree[nxt])
            nb = (bits << 1) | b
            if v & 0x8000:
                codes[(v & 0xFF) - 0x2E] = (nb, nbits + 1)
            else:
                walk(nxt, nb, nbits + 1)

    walk(0, 0, 0)
    lo = min(codes)
    val = np.zeros(max(codes) - lo + 1, np.int32)
    bts = np.zeros_like(val)
    for d, (c, nb) in codes.items():
        val[d - lo] = c
        bts[d - lo] = nb
    return lo, val, bts


DELTA_LO, DELTA_VAL, DELTA_BITS = _invert_delta_tree()

# max preadjustment column count across formats (PREADJ3 has 5 distinct)
PMAX = max(len(set(np.asarray(T.PREADJ0).tolist())),
           len(set(np.asarray(T.PREADJ3).tolist())))


# ----------------------------------------------------------------------
# per-stream setup (host, deterministic): band stats → cutoff, header
# scale codes, thresholds, per-format LUTs

@dataclass
class FormatSetup:
    fmt_type: int
    sub_type: int
    hdr_scale: np.ndarray        # [16] int
    header: bytes                # 16-byte stream header
    n_p: int                     # live preadjustment columns (1 or len(P))
    pidx_of_prev: np.ndarray     # [16] int — preadj column for prev code
    w_lut: np.ndarray            # [16, 16, PMAX] width per (band, code, p)
    sf_lut: np.ndarray           # [16, 16, PMAX] scale factor (≥1)
    amax_lut: np.ndarray = None  # [16, 16, PMAX] largest coef that fits
    amin_lut: np.ndarray = None  # [16, 16, PMAX] smallest coef that fits


@dataclass
class StreamSetup:
    n_frames: int
    bands_keep: int
    thr: np.ndarray              # [16] int32 — per-band error sum threshold
    sil_max: int                 # band is silent iff (max-min) <= sil_max
    formats: list = field(default_factory=list)   # [FormatSetup]


def _int_lt_threshold(x):
    """Largest integer d with d < x (for canonical integer comparison
    against a float threshold)."""
    f = int(np.floor(x))
    return f - 1 if f == x else f


def setup94(ci, params, wanted=None):
    """Compute the per-stream setup from canonical coefficients.

    ci: [F, 255] int32.  wanted: iterable of (type, subtype) candidates to
    build (default: all four, filtered by params).  All math here is
    integer or host-float64 scalar — identical for the numpy and device
    paths (both call this on the host).
    """
    F = ci.shape[0]
    ci64 = ci.astype(np.int64)

    # band cutoff by cumulative size-normalized RMS share
    # (reference: DCSEncoder.cpp:743-771)
    energy = np.zeros(16, dtype=np.int64)
    maxabs = np.zeros(16, dtype=np.int64)
    for b in range(16):
        s, n = BAND_START[b], BAND_SIZES[b]
        seg = ci64[:, s:s + n]
        energy[b] = np.sum(seg * seg)
        maxabs[b] = np.abs(seg).max() if F else 0
    rms = np.sqrt(energy / (max(F, 1) * BAND_SIZES))
    total = rms.sum()
    bands_keep = 16
    if total > 0:
        cum = np.cumsum(rms) / total
        over = np.nonzero(cum >= params.power_band_cutoff)[0]
        if over.size:
            bands_keep = int(over[0])
    bands_keep = max(1, min(16, bands_keep))

    # thresholds
    err_ps = (params.maximum_quantization_error * 32768.0) ** 2
    thr = np.minimum(np.floor(err_ps * BAND_SIZES), 2 ** 30).astype(np.int32)
    sil_max = _int_lt_threshold(params.minimum_dynamic_range * 2 * 32768.0)

    st = StreamSetup(n_frames=F, bands_keep=bands_keep, thr=thr,
                     sil_max=sil_max)

    # per-band bit budget → header scale codes (DCSEncoder.cpp:876-956)
    bits_per_frame = params.target_bit_rate / (RATE / FRAME)
    share_norm = int(np.sum(_BAND_SHARE[:bands_keep]
                            * BAND_SIZES[:bands_keep]))
    base_code = np.zeros(16, dtype=np.int64)
    for b in range(bands_keep):
        bits_b = int(_BAND_SHARE[b] / share_norm * bits_per_frame)
        full = int(maxabs[b])
        target = -(-full // (1 << bits_b)) if full > 0 else 1
        # the reference walks codes in ascending order and stops at the
        # first factor >= target, keeping the last smaller one; factors
        # are non-decreasing, so that is searchsorted minus one
        cnt = int(np.searchsorted(_SCALE64, target, side="left"))
        base_code[b] = max(0, cnt - 1)

    if wanted is None:
        wanted = [f for f in FORMATS
                  if (params.stream_format_type < 0
                      or params.stream_format_type == f[0])
                  and (params.stream_format_subtype < 0
                       or params.stream_format_subtype == f[1])]
        if not wanted:
            raise ValueError(
                "No available stream format types match the requested "
                "encoding parameters")

    for (t, sub) in wanted:
        st.formats.append(_format_setup(t, sub, base_code, bands_keep))
    return st


def _format_setup(t, sub, base_code, bands_keep):
    preadj_map = np.asarray(T.PREADJ0 if sub == 0 else T.PREADJ3)
    if t == 1:
        pvals = sorted(set(int(x) for x in preadj_map))
        pidx_of_prev = np.asarray([pvals.index(int(preadj_map[c]))
                                   for c in range(16)], dtype=np.int64)
        n_p = len(pvals)
    else:
        pvals = [0]
        pidx_of_prev = np.zeros(16, dtype=np.int64)
        n_p = 1

    hdr_scale = np.zeros(16, dtype=np.int64)
    for b in range(bands_keep):
        code = int(base_code[b])
        if t == 1:
            adjust = (0x0D if b < 3 else 0x17) + (1 if sub == 0 else 3)
            code = max(0, code - adjust)
        hdr_scale[b] = code

    header = bytearray(16)
    for b in range(16):
        header[b] = int(hdr_scale[b]) if b < bands_keep else 0xFF
    if t != 0:
        header[0] |= 0x80
    header[1] |= (sub & 0x02) << 6
    header[2] |= (sub & 0x01) << 7

    # (band, code, p) → width / scale factor, fully vectorized
    kept = np.arange(16) < bands_keep                        # [16] bands
    codes = np.arange(16)                                    # [16] codes
    pcols = np.asarray([pvals[min(pi, n_p - 1)] for pi in range(PMAX)])
    p_eff = np.zeros((16, PMAX), dtype=np.int64)             # [band, pi]
    if t == 1:
        p_eff[:3] = pcols[None, :]
    if t == 0:
        w = np.broadcast_to(codes[None, :, None], (16, 16, PMAX))
        sc = np.broadcast_to(hdr_scale[:, None, None], (16, 16, PMAX))
    else:
        xl = np.stack([_xlat_for(b) for b in range(16)])     # [16, 16, 2]
        w = np.broadcast_to(xl[:, :, 0][:, :, None], (16, 16, PMAX))
        sc = (hdr_scale[:, None, None] + xl[:, :, 1][:, :, None]
              + p_eff[:, None, :])
    live = kept[:, None, None] & (codes[None, :, None] >= 1)
    w_lut = np.where(live, w, 0).astype(np.int32)
    sf_lut = np.where(live, _SCALEANY[sc & 63], 1).astype(np.int32)

    # coefficient-domain fit window per (band, code, p): the width w can
    # represent quantized values in [-2^(w-1), 2^(w-1)-1], and
    # rdiv(a, sf) <= L  ⟺  a <= (sf·(2L+1) − 1) // 2, so the per-frame
    # fit test reduces to comparing the band min/max against these limits
    half = np.int64(1) << np.maximum(w_lut.astype(np.int64) - 1, 0)
    sf64 = sf_lut.astype(np.int64)
    amax_lut = ((sf64 * (2 * (half - 1) + 1) - 1) // 2).astype(np.int32)
    amin_lut = (-((sf64 * (2 * half + 1) - 1) // 2)).astype(np.int32)
    return FormatSetup(fmt_type=t, sub_type=sub, hdr_scale=hdr_scale,
                       header=bytes(header), n_p=n_p,
                       pidx_of_prev=pidx_of_prev, w_lut=w_lut, sf_lut=sf_lut,
                       amax_lut=amax_lut, amin_lut=amin_lut)


# ----------------------------------------------------------------------
# decision tables + band-type scan (numpy implementation)

# flat [255]-position helpers: band id, position-within-band, and whether
# the next position is still in the same band (zero runs never cross bands)
BAND_OF = np.repeat(np.arange(16), BAND_SIZES)
POS_IN_BAND = np.concatenate([np.arange(n) for n in BAND_SIZES])
NOT_BAND_LAST = np.concatenate(
    [(np.arange(n) != n - 1) for n in BAND_SIZES])


def band_minmax(ci):
    """Per-(frame, band) min/max of the canonical coefficients."""
    mn = np.minimum.reduceat(ci, BAND_START, axis=1)
    mx = np.maximum.reduceat(ci, BAND_START, axis=1)
    return mn, mx


def decision_tables_np(ci, st: StreamSetup, fs: FormatSetup):
    """Best-code tables for one format: returns (best15, best14, silent),
    best* [F, 16, PMAX] int64, silent [F, 16] bool.

    Canonical selection rule: the chosen code is the smallest candidate
    whose width represents the band's quantized range without two's-
    complement wrap (quantization error is non-decreasing in the code —
    wider codes pair with coarser scale factors — so the narrowest fitting
    code is also the least-error choice; the reference's width walk,
    DCSEncoder.cpp:1502-1621, lands on the same code whenever errors
    behave monotonically).  If no candidate fits, the widest-range
    candidate (hi) is used and the samples clip.  The test needs only the
    band min/max (compared against precomputed coefficient-domain limits),
    so the decision costs O(F·16·15) compares with no sample axis at all.
    """
    F = ci.shape[0]
    n_p = fs.n_p if fs.fmt_type == 1 else 1

    mn, mx = band_minmax(ci)                           # [F, 16] int32
    fit = ((mn[:, :, None, None] >= fs.amin_lut[None, :, 1:, :n_p])
           & (mx[:, :, None, None] <= fs.amax_lut[None, :, 1:, :n_p]))

    first = fit.argmax(axis=2)                         # first fit (or 0)
    any_ = fit.any(axis=2)
    b15 = np.where(any_, first + 1, 15).astype(np.int32)

    out15 = np.zeros((F, 16, PMAX), dtype=np.int32)
    out15[:, :, :n_p] = b15
    # the hi=14 variant (previous code 0 forbids code 15) differs only
    # where the first fit is 15: codes 1..14 then don't fit, so it falls
    # back to 14 — derivable without a second search
    out15, out14 = _wrap_refine_np(ci, st, fs, out15, n_p)

    silent = (mx - mn) <= st.sil_max                   # [F, 16]
    return out15, out14, silent


# wrap-tolerant refinement candidate range: only low codes can ever absorb
# a two's-complement wrap within the error budget (a wrapped sample's
# error is at least (2^w·sf − sf/2)², which exceeds any realistic budget
# once the represented range is wide)
WRAP_CMAX = 6
D_CLAMP = 5793          # per-sample |diff| clamp: 5793² < 2³¹/32


def _wrap_refine_np(ci, st, fs, out15, n_p):
    """Allow codes narrower than the fitting one when their exact
    quantization error (including wrap distortion) stays within the
    maximum-quantization-error budget — the lever through which
    CompressionParams.maximum_quantization_error shapes the stream
    (reference: FindBestBandEncoding's error walk, DCSEncoder.cpp:
    1502-1621).  Candidates are codes 1..WRAP_CMAX below the fitting code;
    the final choice is lexicographic-min by (width, code) among passing
    candidates and the fitting code.

    The host skips candidates that provably cannot pass (wrap error floor
    above the budget); the device twin evaluates all of them — both reach
    identical results because the skip is conservative."""
    import math
    F = ci.shape[0]
    mn, mx = band_minmax(ci)
    out14 = np.where(out15 == 15, 14, out15)
    # per-(band, pi) max fitting code across frames: a candidate c can
    # only matter when some frame's fitting code exceeds it
    cmax15 = out15.max(axis=0)            # [16, PMAX]
    BIG = np.int32(1 << 14)
    for b in range(st.bands_keep):
        s, n = BAND_START[b], BAND_SIZES[b]
        thr = int(st.thr[b])
        cape = min(thr + 1, 1 << 25)
        d = math.isqrt(max(thr, 0)) + 1       # per-sample |diff| ≤ √thr
        # flagged candidates for this band: (c, pi) whose wrap-error floor
        # is within budget AND that undercut some frame's fitting code
        cands = []
        for pi in range(n_p):
            hi = int(cmax15[b, pi])
            for c in range(1, min(WRAP_CMAX, hi - 1) + 1):
                w = int(fs.w_lut[b, c, pi])
                sf = int(fs.sf_lut[b, c, pi])
                if w < 1:
                    continue
                if ((1 << w) * sf - sf // 2) ** 2 > thr:
                    continue              # cannot pass — safe host skip
                cands.append((c, pi, w, sf))
        if not cands:
            continue
        # error sums depend only on (w, sf) — evaluate each pair once.
        # A pass requires every sample within √thr of the representable
        # window [-2^(w-1)·sf, (2^(w-1)-1)·sf] (reconstruction is NOT
        # modular), so frames whose band min/max fall outside are proven
        # failures — only the feasible frames pay the exact error sum.
        uniq = sorted(set((w, sf) for (_, _, w, sf) in cands))
        uidx = {ws: k for k, ws in enumerate(uniq)}
        sf_k = np.asarray([sf for (_, sf) in uniq], dtype=np.int32)
        w_k = np.asarray([w for (w, _) in uniq], dtype=np.int32)
        half_k = (np.int32(1) << (w_k - 1)) * sf_k
        feas = ((mx[:, b, None] <= half_k - sf_k + d)
                & (mn[:, b, None] >= -half_k - d))       # [F, K]
        rows = np.nonzero(feas.any(axis=1))[0]
        ok_k = np.zeros((ci.shape[0], len(uniq)), dtype=bool)
        if rows.size:
            seg = ci[rows, s:s + n, None]                # [R, n, 1]
            q = rdiv(np.broadcast_to(seg, seg.shape[:2] + (len(uniq),)),
                     sf_k)
            ref = np.int32(1) << (w_k - 1)
            mask = (np.int32(1) << w_k) - 1
            stored = (q + ref) & mask
            diff = (stored - ref) * sf_k - seg
            dc = np.minimum(np.abs(diff), D_CLAMP)
            e = np.minimum(dc * dc, np.int32(cape))
            es = e.sum(axis=1, dtype=np.int64).astype(np.int32)
            ok_k[rows] = es <= thr
        # min candidate key (width·16 + code) per (frame, pi); the same
        # set serves both variants: candidates have c ≤ 6, so c < out15
        # ⟺ c < out14 (they differ only when out15 = 15, out14 = 14)
        candmin = np.full((F, n_p), BIG, dtype=np.int32)
        for (c, pi, w, sf) in cands:
            ok = ok_k[:, uidx[(w, sf)]]
            if not ok.any():
                continue
            key = np.int32(w * 16 + c)
            col = candmin[:, pi]
            upd = ok & (c < out15[:, b, pi]) & (key < col)
            candmin[:, pi] = np.where(upd, key, col)
        pc = np.arange(n_p)
        o15 = out15[:, b, :n_p]
        key15 = fs.w_lut[b, o15, pc[None, :]].astype(np.int32) * 16 + o15
        new15 = np.minimum(candmin, key15) & 15
        key14 = (fs.w_lut[b, 14, pc].astype(np.int32) * 16 + 14)[None, :]
        new14 = np.where(o15 == 15,
                         np.minimum(candmin, key14) & 15, new15)
        out15[:, b, :n_p] = new15
        out14[:, b, :n_p] = new14
    return out15, out14


def scan_codes_np(best15, best14, silent, st: StreamSetup, fs: FormatSetup):
    """Sequential band-type scan: codes[f] depends on the previous frame's
    code through the delta-range constraint (prev==0 excludes code 15) and,
    for type-1 bands 0-2, the scale pre-adjustment.  Returns (codes, pidx)
    [F, 16] int64."""
    F = best15.shape[0]
    codes = np.zeros((F, 16), dtype=np.int64)
    pidx = np.zeros((F, 16), dtype=np.int64)
    pip = fs.pidx_of_prev
    for b in range(st.bands_keep):
        dep = fs.fmt_type == 1 and b < 3
        sil = silent[:, b]
        prev = 0
        col = codes[:, b]
        pcol = pidx[:, b]
        b15l = best15[:, b, :].tolist()
        b14l = best14[:, b, :].tolist()
        sill = sil.tolist()
        for f in range(F):
            pi = pip[prev] if dep else 0
            if sill[f]:
                c = 0
            else:
                c = b14l[f][pi] if prev == 0 else b15l[f][pi]
            col[f] = c
            pcol[f] = pi
            prev = c
    return codes, pidx


def emit94_np(ci, st: StreamSetup, fs: FormatSetup, codes, pidx):
    """Symbol emission: returns (vals, bits) [F, 16 + 255] int64 whose
    row-major flatten is the exact bitstream emission order (per frame:
    band-type delta codes, then each band's samples in position order)."""
    F = ci.shape[0]
    keep = np.arange(16) < st.bands_keep

    # band-type delta codes
    prev_rows = np.vstack([np.zeros((1, 16), codes.dtype), codes[:-1]])
    deltas = codes - prev_rows
    dv = DELTA_VAL[deltas - DELTA_LO]
    db = np.where(keep[None, :], DELTA_BITS[deltas - DELTA_LO], 0)

    # per-band width/scale gathered to flat positions
    bw_b = fs.w_lut[np.arange(16)[None, :], codes, pidx]      # [F,16]
    sf_b = fs.sf_lut[np.arange(16)[None, :], codes, pidx]
    live_b = (codes != 0) & (bw_b != 0)
    bw = bw_b[:, BAND_OF]                                     # [F,255]
    q = rdiv(ci, sf_b[:, BAND_OF].astype(np.int32))
    is_cb = (bw >= 1) & (bw <= 6)
    ref = np.where(is_cb, 1 << np.maximum(bw - 1, 0), 0)
    mask = (1 << np.maximum(bw, 1)) - 1
    vals = (q + ref) & mask

    live = live_b[:, BAND_OF]
    bwc = np.clip(bw, 0, 6)
    tz_ok = TZ_BITS[bwc] > 0

    # greedy zero pairing within each band (closed form over zero runs;
    # runs break at band boundaries via the position-in-band columns)
    zero = (q == 0) & is_cb & live & tz_ok
    in_run = np.concatenate(
        [np.zeros((F, 1), bool), zero[:, :-1]], axis=1) & (POS_IN_BAND != 0)
    starts = zero & ~in_run
    gcol = np.arange(255)[None, :]
    run_start = np.maximum.accumulate(np.where(starts, gcol, -1), axis=1)
    offset = gcol - run_start
    next_zero = np.concatenate(
        [zero[:, 1:], np.zeros((F, 1), bool)], axis=1) & NOT_BAND_LAST
    pair_head = zero & (offset % 2 == 0) & next_zero
    shadow = np.concatenate(
        [np.zeros((F, 1), bool), pair_head[:, :-1]], axis=1)

    cb_code = CB_CODE[bwc, vals & 63]
    cb_bits = CB_BITS[bwc, vals & 63]
    svals = np.where(is_cb, cb_code, vals)
    sbits = np.where(is_cb, cb_bits, bw)
    svals = np.where(pair_head, TZ_CODE[bwc], svals)
    sbits = np.where(pair_head, TZ_BITS[bwc], sbits)
    sbits = np.where(live & ~shadow, sbits, 0)

    out_v = np.concatenate([dv, svals], axis=1)
    out_b = np.concatenate([db, sbits], axis=1)
    return out_v, out_b


def pack_bits(values, bits):
    """MSB-first pack of variable-width symbols (bits == 0 emits nothing);
    bit-identical to feeding each (value, width) through a BitWriter.
    Uses the native packer when available (bit-identical by test)."""
    from .. import native
    out = native.pack_bits(values, bits)
    if out is not None:
        return out
    values = np.asarray(values, dtype=np.int64).reshape(-1)
    bits = np.asarray(bits, dtype=np.int64).reshape(-1)
    total = int(bits.sum())
    if total == 0:
        return b""
    nz = bits > 0
    values, bits = values[nz], bits[nz]
    reps = np.repeat(np.arange(bits.size), bits)
    offs = np.concatenate([[0], np.cumsum(bits)[:-1]])
    k = np.arange(total) - offs[reps]
    shift = bits[reps] - 1 - k
    bitarr = ((values[reps] >> shift) & 1).astype(np.uint8)
    return np.packbits(bitarr).tobytes()


def skip_dup_format(formats):
    """Under the wildcard search, (0,3) is body-identical to (0,0) — for
    type 0 the subtype bits only flip header flags and the pre-adjustment
    tables they select never apply — so when both are candidates the
    search outcome is decided by (0,0) and (0,3) need not be built.  The
    device twin applies the same rule (byte-identical winners)."""
    pairs = [(f.fmt_type, f.sub_type) for f in formats]
    if (0, 0) in pairs and (0, 3) in pairs:
        return [f for f in formats if (f.fmt_type, f.sub_type) != (0, 3)]
    return list(formats)


def encode_stream94_np(ci, params, force_numpy=False):
    """Full single-stream encode from canonical coefficients: runs the
    format search, packs only the winner.  Returns stream bytes.

    Prefers the native scalar core (native/src/encoder94.cpp, byte-identical
    by construction and by test); force_numpy pins the vectorized numpy
    implementation (used by the parity tests and as the fallback)."""
    st = setup94(ci, params)
    formats = skip_dup_format(st.formats)
    if not force_numpy:
        from .. import native
        r = native.encode94_search(ci, formats, st.bands_keep, st.thr,
                                   st.sil_max)
        if r is not None:
            k, body = r
            return (st.n_frames.to_bytes(2, "big") + formats[k].header
                    + body)
    best = None
    for fs in formats:
        b15, b14, silent = decision_tables_np(ci, st, fs)
        codes, pidx = scan_codes_np(b15, b14, silent, st, fs)
        vals, bits = emit94_np(ci, st, fs, codes, pidx)
        nbytes = 18 + (int(bits.sum()) + 7) // 8
        if best is None or nbytes < best[0]:
            best = (nbytes, fs, vals, bits)
    nbytes, fs, vals, bits = best
    out = bytearray()
    out += st.n_frames.to_bytes(2, "big")
    out += fs.header
    out += pack_bits(vals, bits)
    assert len(out) == nbytes
    return bytes(out)
