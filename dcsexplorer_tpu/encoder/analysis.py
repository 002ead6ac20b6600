"""Encoder analysis transform: the forward counterpart of the decoder IFFT.

Design: instead of porting the reference's scalar split-radix DFT
(reference: DCSEncoder.cpp:1019-1500), we exploit that the decoder's inverse
transform (ops/transform.py, float-idealized without rounding/saturation) is a
LINEAR map D from frame-buffer coefficients to the 256 time-domain samples.
The encoder's analysis transform is its least-squares inverse, precomputed
once as a 256×255 matrix — so encoding a whole stream's frames is a single
batched matmul.

Coefficient-space convention (matching the decoder's first-sample fixup,
DCSDecoderNative.cpp:2254-2257): slot 1 is forced to zero by the decoder and
the value *transmitted* at slot 1 lands in slot 0, so the transmit vector has
255 live dimensions: [slot0, slot2, slot3, ..., slot255].
"""

import numpy as np

from ..format import tables as T

_BR = np.asarray(T.BITREV9)
_IFFT = np.asarray(T.IFFT_COEFF)


def _s16f(x):
    return np.where(x >= 0x8000, x - 0x10000, x).astype(np.float64)


def _float_transform94(fb):
    """Float-idealized decoder transform: fb [B, 512] (float, 1.15 domain
    ±32768) → time samples [B, 256] in natural order (outputs 0..239 then the
    16 overlap-tail samples).  Mirrors ops/transform.transform94_raw without
    rounding, saturation, or volume shift."""
    fb = fb.astype(np.float64).copy()
    B = fb.shape[0]
    sin = _s16f(_IFFT[:128])
    cos = _s16f(_IFFT[128:])

    fb[:, 0x80] = -fb[:, 0x80]
    fb[:, 0x81] = fb[:, 0x81]      # mulss(-x, 0x8000) = x

    idx_x = np.arange(0, 128)
    idx_y = np.empty(128, dtype=np.int64)
    for i in range(64):
        idx_y[2 * i] = 0x100 - 2 * i
        idx_y[2 * i + 1] = 0x101 - 2 * i

    x = fb[:, idx_x]
    y = fb[:, idx_y]
    x0, x1 = x[:, 0::2], x[:, 1::2]
    y0, y1 = y[:, 0::2], y[:, 1::2]
    n_x0, n_y0 = -(x0 + y0), -(x0 - y0)
    n_x1, n_y1 = -(x1 - y1), -(x1 + y1)
    fb[:, idx_x[0::2]], fb[:, idx_x[1::2]] = n_x0, n_x1
    fb[:, idx_y[0::2]], fb[:, idx_y[1::2]] = n_y0, n_y1

    c0 = _s16f(_IFFT[_BR[2 + 4 * np.arange(64)]]) / 32768.0
    c1 = _s16f(_IFFT[_BR[4 * np.arange(64)]]) / 32768.0
    x = fb[:, idx_x]
    y = fb[:, idx_y]
    x0, x1 = x[:, 0::2], x[:, 1::2]
    yn0, yn1 = y[:, 0::2], y[:, 1::2]
    prod0 = yn1 * c1 - yn0 * c0
    prod1 = yn1 * c0 + yn0 * c1
    fb[:, idx_x[0::2]] = prod1 + x0
    fb[:, idx_x[1::2]] = prod0 + x1
    fb[:, idx_y[0::2]] = x0 - prod1
    fb[:, idx_y[1::2]] = prod0 - x1

    xx = fb[:, 0:128].copy()
    yy = fb[:, 128:256].copy()
    fb[:, 0:128] = xx + yy
    fb[:, 128:256] = xx - yy

    core = fb[:, :256]
    n_part, part = 2, 0x40
    for _ in range(6):
        v = core.reshape(B, n_part, 2, part)
        u, a = v[:, :, 0, :].copy(), v[:, :, 1, :]
        ap = a.reshape(B, n_part, part // 2, 2)
        a_re, a_im = ap[..., 0], ap[..., 1]
        cc = (cos[:n_part] / 32768.0).reshape(1, n_part, 1)
        cs = (sin[:n_part] / 32768.0).reshape(1, n_part, 1)
        t_re = a_re * cc - a_im * cs
        t_im = a_im * cc + a_re * cs
        up = u.reshape(B, n_part, part // 2, 2)
        u_re, u_im = up[..., 0], up[..., 1]
        nu = np.stack([u_re - t_re, u_im - t_im], axis=-1)
        na = np.stack([u_re + t_re, u_im + t_im], axis=-1)
        core = np.stack([nu.reshape(B, n_part, part),
                         na.reshape(B, n_part, part)], axis=2).reshape(B, 256)
        n_part *= 2
        part //= 2

    # natural-order extraction (outputs 0..239, then overlap tail 240..255)
    ext = np.empty(256, dtype=np.int64)
    for i in range(0, 256, 2):
        ext[i] = _BR[i]
        ext[i + 1] = _BR[i] + 1
    return core[:, ext]


# frame-buffer slots that carry transmitted coefficients (slot 1's payload
# lands in slot 0 via the fixup; slot 1 itself is always zero)
LIVE_SLOTS = np.array([0] + list(range(2, 256)), dtype=np.int64)   # 255 dims


def _build_matrices():
    basis = np.zeros((255, 512))
    for k, s in enumerate(LIVE_SLOTS):
        basis[k, s] = 32768.0
    D = _float_transform94(basis) / 32768.0      # [255 coef dims, 256 time]
    F = np.linalg.pinv(D)                        # [256 time, 255 coef]
    return D.astype(np.float32), F.astype(np.float32)


_D, _F = None, None


def decoder_matrix():
    global _D, _F
    if _D is None:
        _D, _F = _build_matrices()
    return _D


def forward_matrix():
    """[256 time, 255 coef] analysis matrix: coef = time @ F."""
    global _D, _F
    if _F is None:
        _D, _F = _build_matrices()
    return _F


def analyze_frames(time_frames, algorithm="pinv"):
    """time_frames: [F, 256] float (±32768 domain) → transmit coefficients
    [F, 255] (order: slot0, slot2..slot255), float.

    algorithm selects the forward transform, mirroring the reference's two
    DFT algorithms + cross-check (DCSEncoder.cpp:1019-1035: DFTAlgorithmOrig
    is production, DFTAlgorithmNew is the independent clean derivation kept
    for comparison):

    - "pinv" (default, production): the least-squares inverse — one
      batched matmul.
    - "butterfly": the decoder transform's passes inverted in closed form
      (forward butterfly recursion + inverse twiddle folds).  Exact on D's
      range; differs from pinv only in the never-transmitted null
      component, the same relationship the reference's two algorithms have.
    - "dual": run both, assert they agree on the transmittable component,
      return the production result.
    """
    if algorithm == "pinv":
        return np.asarray(time_frames, dtype=np.float32) @ forward_matrix()
    if algorithm == "butterfly":
        return analyze_frames_butterfly(time_frames)
    if algorithm == "dual":
        a = np.asarray(time_frames, dtype=np.float32) @ forward_matrix()
        b = analyze_frames_butterfly(time_frames)
        # compare in the transmittable domain: project both through the
        # decoder matrix (null-space components don't reach the wire)
        ta = a.astype(np.float32) @ decoder_matrix()
        tb = b.astype(np.float32) @ decoder_matrix()
        err = float(np.max(np.abs(ta - tb)))
        ref = float(np.max(np.abs(ta)) + 1e-6)
        if err > 1e-3 * ref:
            raise AssertionError(
                f"analysis transforms diverge: {err:.3e} vs scale {ref:.3e}")
        return a
    raise ValueError(f"unknown analysis algorithm: {algorithm!r}")


def analyze_frames_butterfly(time_frames):
    """Alternative analysis transform: run the decoder's inverse transform
    BACKWARDS, pass by pass (counterpart of the reference's independent
    second algorithm, DCSEncoder.cpp:1102-1216).

    Every decoder pass is exactly invertible in float: the extraction is a
    permutation, each butterfly (u,a) -> (u-t, u+t) with t = rot(a) solves
    to u = (b+c)/2, a = rot^-1((c-b)/2) (the quantized twiddle rotation
    inverts by its own 2x2 determinant), and the pre-twiddle folds are
    2x2 blocks.  Returns [F, 255] transmit coefficients like
    analyze_frames; agrees with pinv on the transmittable component.
    """
    out = np.asarray(time_frames, dtype=np.float64)
    B = out.shape[0]
    sin = _s16f(_IFFT[:128]) / 32768.0
    cos = _s16f(_IFFT[128:]) / 32768.0

    # 1) invert the natural-order extraction (a permutation)
    ext = np.empty(256, dtype=np.int64)
    for i in range(0, 256, 2):
        ext[i] = _BR[i]
        ext[i + 1] = _BR[i] + 1
    inv_ext = np.argsort(ext)
    core = out[:, inv_ext]

    # 2) undo the 6 butterfly iterations, last first
    n_part, part = 64, 0x2  # state at the final iteration
    for _ in range(6):
        v = core.reshape(B, n_part, 2, part)
        nu, na = v[:, :, 0, :], v[:, :, 1, :]
        u = (nu + na) / 2.0
        t = (na - nu) / 2.0
        tp = t.reshape(B, n_part, part // 2, 2)
        t_re, t_im = tp[..., 0], tp[..., 1]
        cc = cos[:n_part].reshape(1, n_part, 1)
        cs = sin[:n_part].reshape(1, n_part, 1)
        det = cc * cc + cs * cs
        a_re = (t_re * cc + t_im * cs) / det
        a_im = (t_im * cc - t_re * cs) / det
        a = np.stack([a_re, a_im], axis=-1).reshape(B, n_part, part)
        core = np.stack([u, a], axis=2).reshape(B, 256)
        n_part //= 2
        part *= 2

    fb = np.zeros((B, 512), dtype=np.float64)
    fb[:, :256] = core

    # 3) undo the butterfly-halves fold: a' = x+y, b' = x-y
    aa = fb[:, 0:128].copy()
    bb = fb[:, 128:256].copy()
    fb[:, 0:128] = (aa + bb) / 2.0
    fb[:, 128:256] = (aa - bb) / 2.0

    # 4) undo pre-pass 2 (complex twiddle fold)
    idx_x = np.arange(0, 128)
    idx_y = np.empty(128, dtype=np.int64)
    for i in range(64):
        idx_y[2 * i] = 0x100 - 2 * i
        idx_y[2 * i + 1] = 0x101 - 2 * i
    c0 = _s16f(_IFFT[_BR[2 + 4 * np.arange(64)]]) / 32768.0
    c1 = _s16f(_IFFT[_BR[4 * np.arange(64)]]) / 32768.0
    px0 = fb[:, idx_x[0::2]].copy()
    px1 = fb[:, idx_x[1::2]].copy()
    py0 = fb[:, idx_y[0::2]].copy()
    py1 = fb[:, idx_y[1::2]].copy()
    x0 = (px0 + py0) / 2.0
    prod1 = (px0 - py0) / 2.0
    x1 = (px1 - py1) / 2.0
    prod0 = (px1 + py1) / 2.0
    det = c0 * c0 + c1 * c1
    yn1 = (prod0 * c1 + prod1 * c0) / det
    yn0 = (prod1 * c1 - prod0 * c0) / det
    fb[:, idx_x[0::2]] = x0
    fb[:, idx_x[1::2]] = x1
    fb[:, idx_y[0::2]] = yn0
    fb[:, idx_y[1::2]] = yn1

    # 5) undo pre-pass 1 (±sums then negate)
    nx0 = fb[:, idx_x[0::2]].copy()
    nx1 = fb[:, idx_x[1::2]].copy()
    ny0 = fb[:, idx_y[0::2]].copy()
    ny1 = fb[:, idx_y[1::2]].copy()
    fb[:, idx_x[0::2]] = -(nx0 + ny0) / 2.0
    fb[:, idx_y[0::2]] = (ny0 - nx0) / 2.0
    fb[:, idx_x[1::2]] = -(nx1 + ny1) / 2.0
    fb[:, idx_y[1::2]] = (nx1 - ny1) / 2.0

    # 6) undo the center fixups (both self-inverse in float)
    fb[:, 0x80] = -fb[:, 0x80]

    # 7) pair 0 special case: its y side is slots 0x100/0x101, which are
    # identically ZERO in any valid input (the transform only transmits
    # slots 0..255), so the generic 2x2 fold inverse above is rank-
    # deficient there.  With y = 0 the forward chain for the pair is
    #   px0 = -(1 + c1[0])*fb0 - c0[0]*fb1
    #   px1 =  c0[0]*fb0 - (1 + c1[0])*fb1
    # which solves directly for the original fb[0], fb[1]:
    a = 1.0 + c1[0]
    b = c0[0]
    det0 = a * a + b * b
    fb[:, 0] = (-a * px0[:, 0] + b * px1[:, 0]) / det0
    fb[:, 1] = (-b * px0[:, 0] - a * px1[:, 0]) / det0

    # transmit order: slot0, slot2..slot255.  Slot 1's residual is the
    # never-transmitted null component (the reference's always-zero
    # sine(0*n) sum, DCSEncoder.cpp:1036-1042) — dropped.
    return fb[:, LIVE_SLOTS].astype(np.float32)


# ----------------------------------------------------------------------
# 1993-format analysis (counterpart of ops/transform.transform93_raw)

def _float_transform93(fb):
    """Float-idealized 1993 decoder transform: fb [B, 512] → time [B, 256].

    Mirrors ops/transform.transform93_raw without rounding/saturation or the
    volume shift.  Slots 0 and 1 must be zero on input (the real decoder
    feeds them through a nonlinear Taylor-sqrt magnitude fixup; the encoder
    simply never transmits energy there, which keeps the map linear)."""
    from ..ops import transform as tf
    fb = fb.astype(np.float64).copy()
    B = fb.shape[0]
    sin = _s16f(_IFFT[:128]) / 32768.0
    cos = _s16f(_IFFT[128:]) / 32768.0

    fb[:, 0x000] = 0.0
    fb[:, 0x001] = 0.0
    fb[:, 0x100] = 0.0
    fb[:, 0x101] = 0.0

    # expand 256 → 512 (index maps shared with the exact kernel)
    i0, i1 = np.asarray(tf._E93_I0), np.asarray(tf._E93_I1)
    i2, i3 = np.asarray(tf._E93_I2), np.asarray(tf._E93_I3)
    xr, xi = fb[:, i0].copy(), fb[:, i0 + 1].copy()
    yr, yi = fb[:, i1].copy(), fb[:, i1 + 1].copy()
    fb[:, i0] = xr + yr
    fb[:, i1] = xr + yr
    fb[:, i2] = xr - yr
    fb[:, i3] = yr - xr
    fb[:, i2 + 1] = xi + yi
    fb[:, i3 + 1] = xi + yi
    fb[:, i0 + 1] = xi - yi
    fb[:, i1 + 1] = yi - xi

    core = fb
    n_part, part = 2, 0x80
    for _ in range(7):
        v = core.reshape(B, n_part, 2, part)
        u, a = v[:, :, 0, :].copy(), v[:, :, 1, :]
        ap = a.reshape(B, n_part, part // 2, 2)
        a_re, a_im = ap[..., 0], ap[..., 1]
        cc = cos[:n_part].reshape(1, n_part, 1)
        cs = sin[:n_part].reshape(1, n_part, 1)
        t_re = a_re * cc - a_im * cs
        t_im = a_im * cc + a_re * cs
        up = u.reshape(B, n_part, part // 2, 2)
        u_re, u_im = up[..., 0], up[..., 1]
        nu = np.stack([u_re - t_re, u_im - t_im], axis=-1)
        na = np.stack([t_re + u_re, t_im + u_im], axis=-1)
        core = np.stack([nu.reshape(B, n_part, part),
                         na.reshape(B, n_part, part)], axis=2).reshape(B, 512)
        n_part *= 2
        part //= 2

    return core[:, np.asarray(tf._BR93)]


# 93 transmit dims: fb slots 2..255 (slot 0/1 stay zero for linearity; the
# dead fb slot 256 of format-type-0 streams is likewise never used)
LIVE_SLOTS93 = np.arange(2, 256, dtype=np.int64)    # 254 dims

_D93, _F93 = None, None


def _build_matrices93():
    basis = np.zeros((254, 512))
    for k, s in enumerate(LIVE_SLOTS93):
        basis[k, s] = 32768.0
    D = _float_transform93(basis) / 32768.0
    F = np.linalg.pinv(D)
    return D.astype(np.float32), F.astype(np.float32)


def decoder_matrix93():
    global _D93, _F93
    if _D93 is None:
        _D93, _F93 = _build_matrices93()
    return _D93


def forward_matrix93():
    global _D93, _F93
    if _F93 is None:
        _D93, _F93 = _build_matrices93()
    return _F93


def analyze_frames93(time_frames):
    """time_frames: [F, 256] float (±32768 domain) → 93-format coefficients
    [F, 254] for fb slots 2..255."""
    return np.asarray(time_frames, dtype=np.float32) @ forward_matrix93()
