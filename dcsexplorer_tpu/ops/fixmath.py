"""Vectorized ADSP-2105 fixed-point primitives for the device decode path.

Bit-exact JAX/XLA versions of ``refdec/fixed.py``:

- All values live in **int32 with two's-complement wrapping** (XLA integer
  semantics).  Every quantity the decoder extracts is a bit window below bit
  32 of some product/sum chain, and mod-2^32 arithmetic preserves bits 0..31
  exactly, so no int64 is needed anywhere on device.
- uint16 storage convention: arrays hold values in [0, 0xFFFF] as int32
  ("u16-in-int32"); ``s16`` reinterprets as signed.

Numerics contract anchors: reference DCSDecoderNative.h:809-906,
DCSDecoderNative.cpp:3446-3580.
"""

import jax.numpy as jnp

M16 = 0xFFFF


def s16(x):
    """Reinterpret the low 16 bits as signed int16 (stays int32)."""
    return ((x & M16) ^ 0x8000) - 0x8000


def u16(x):
    return x & M16


def sat16(v):
    """Saturate signed value to int16 range; returns u16 storage."""
    return jnp.clip(v, -32768, 32767) & M16


def mulss(a, b):
    """1.15 signed×signed multiply → MR1 word (u16 storage).

    MR1 = bits 16..31 of ((a*b)<<1) = (a*b) >> 15, masked.
    """
    return ((s16(a) * s16(b)) >> 15) & M16


def mulsu(a, b):
    """1.15 signed×unsigned multiply → MR1 word (u16 storage)."""
    return ((s16(a) * u16(b)) >> 15) & M16


def rotate_round(a_re, a_im, c_cos, c_sin):
    """The transform's complex-rotate with MAC rounding.

    Computes (reference: DCSDecoderNative.cpp:437-443, 499-506):
      t_re = s16 round(a_re*c_cos - a_im*c_sin)
      t_im = s16 round(a_im*c_cos + a_re*c_sin)
    with the convergent-rounding quirk keyed on the *second* product of each
    chain.  All inputs in u16 storage; outputs signed int32 in int16 range.
    """
    are, aim = s16(a_re), s16(a_im)
    cc, cs = s16(c_cos), s16(c_sin)

    p_a = are * cc
    p_b = aim * cs
    mr = ((p_a - p_b) << 1) + 0x8000
    quirk = ((p_b << 1) & M16) == 0x8000
    mr = jnp.where(quirk, mr & ~0x10000, mr)
    t_re = s16(mr >> 16)

    p_a2 = aim * cc
    p_b2 = are * cs
    mr2 = ((p_a2 + p_b2) << 1) + 0x8000
    quirk2 = ((p_b2 << 1) & M16) == 0x8000
    mr2 = jnp.where(quirk2, mr2 & ~0x10000, mr2)
    t_im = s16(mr2 >> 16)
    return t_re, t_im


def overlap_mix(new_val, old_val, c_new, c_old):
    """Overlap-add blend with MAC rounding (quirk keyed on prod=0 → inactive).

    round(new*c_new + old*c_old) per reference :538-555 / :789-802;
    new/old in u16 storage (signed), c_* unsigned coefficients.
    """
    a = (s16(new_val) * u16(c_new)) << 1
    b = (s16(old_val) * u16(c_old)) << 1
    res = a + b + 0x8000
    return (res >> 16) & M16


def accum_mix(out_old, sample, scale, mix):
    """Scale-and-mix a band sample into the frame buffer (u16 storage).

    Replicates (reference: DCSDecoderNative.cpp:2244-2250):
      scaled = low16(s16(sample) * u16(scale))
      prod   = (s16(out_old) << 16) | scaled
      prod  += s16(scaled) * u16(mix)
      return bits 16..31 of prod
    """
    scaled = (s16(sample) * u16(scale)) & M16
    prod = (s16(out_old) << 16) | scaled
    prod = prod + s16(scaled) * u16(mix)
    return (prod >> 16) & M16
