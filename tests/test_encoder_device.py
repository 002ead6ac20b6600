"""Batched device encoder (encoder/device94.py) parity vs the numpy core.

The decision pipeline is integer-canonical (encoder/core94.py), so the
batched JAX twin must emit *byte-identical* streams for every stream in the
batch — across signal types, stream lengths (padding buckets), and
compression-parameter settings (reference semantics anchor:
DCSEncoder.cpp:784-853 format search, :1502-1621 band encoding search).
"""

import numpy as np
import pytest

from dcsexplorer_tpu.encoder import analysis
from dcsexplorer_tpu.encoder import core94 as c94
from dcsexplorer_tpu.encoder import device94 as d94
from dcsexplorer_tpu.encoder.encoder import CompressionParams, frames_from_pcm


def _ci(pcm):
    coefs = analysis.analyze_frames(frames_from_pcm(
        np.asarray(pcm, dtype=np.float32)))
    return np.clip(np.rint(coefs), -(1 << 20), 1 << 20).astype(np.int32)


def _corpus(seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(31250) / 31250.0
    sigs = []
    # dense music-like: chords + AM + noise floor
    sigs.append(6000 * np.sin(2 * np.pi * 440 * t)
                + 3000 * np.sin(2 * np.pi * 554.4 * t)
                + 2000 * np.sin(2 * np.pi * 659.3 * t) * np.sin(2 * np.pi * 3 * t)
                + 300 * rng.standard_normal(t.size))
    # broadband noise
    sigs.append(9000 * rng.standard_normal(t.size // 2))
    # near-silence with a transient click (exercises silent bands + wrap)
    s = 20 * rng.standard_normal(t.size // 3)
    s[2000:2100] += 24000 * np.hanning(100)
    sigs.append(s)
    # pure low tone (band cutoff drops most bands)
    sigs.append(12000 * np.sin(2 * np.pi * 130.8 * t[: t.size // 4]))
    # full-scale square-ish (clipping / widest codes)
    sigs.append(28000 * np.sign(np.sin(2 * np.pi * 220 * t[: t.size // 3])))
    return [np.clip(s, -32000, 32000).astype(np.float32) for s in sigs]


PARAM_SETS = [
    CompressionParams(),
    CompressionParams(stream_format_type=0),
    CompressionParams(stream_format_type=1, stream_format_subtype=0),
    CompressionParams(power_band_cutoff=1.0, target_bit_rate=256000,
                      maximum_quantization_error=2.0 / 32768.0),
    CompressionParams(target_bit_rate=48000,
                      maximum_quantization_error=40.0 / 32768.0,
                      minimum_dynamic_range=60.0 / 32768.0),
]


def test_device_batch_byte_identical():
    cis = [_ci(p) for p in _corpus()]
    for params in PARAM_SETS:
        want = [c94.encode_stream94_np(ci, params) for ci in cis]
        got = d94.encode_batch(cis, params)
        for i, (w, g) in enumerate(zip(want, got)):
            assert g == w, (i, params)


def test_device_batch_mixed_lengths():
    # streams spanning different padding buckets in ONE batch
    rng = np.random.default_rng(3)
    cis = []
    for nf in (1, 5, 63, 64, 65, 130):
        ci = rng.integers(-(1 << 14), 1 << 14,
                          size=(nf, 255)).astype(np.int32)
        cis.append(ci)
    params = CompressionParams()
    want = [c94.encode_stream94_np(ci, params) for ci in cis]
    got = d94.encode_batch(cis, params)
    assert got == want


def test_device_single_stream():
    ci = _ci(_corpus()[0])
    params = CompressionParams()
    (got,) = d94.encode_batch([ci], params)
    assert got == c94.encode_stream94_np(ci, params)


# ----------------------------------------------------------------------
# The PCM-planes contract (encoder.py "integer-canonical analysis" module
# comment): the device's int8-plane matmul analysis (_analyze_device)
# must be bit-identical to the host's float64-BLAS evaluation
# (analyze_frames_canonical) for EVERY int16 input — and the end-to-end
# encode_files_device path must therefore be byte-identical to encode_files.

def _adversarial_pcm():
    """int16 inputs where a plane decomposition with nested-shift rounding
    would crack: full-scale limits, DC offsets, impulse trains,
    alternating-sign max amplitude, and dense random extremes."""
    rng = np.random.default_rng(11)
    n = 240 * 9 + 17                       # off-frame-boundary tail
    out = [
        np.full(n, 32767, np.int16),                       # +full-scale DC
        np.full(n, -32768, np.int16),                      # -full-scale DC
        np.full(n, -1, np.int16),                          # all-ones bytes
        np.where(np.arange(n) % 2 == 0, 32767, -32768)     # alternating max
          .astype(np.int16),
    ]
    imp = np.zeros(n, np.int16)
    imp[::97] = 32767
    imp[1::193] = -32768
    out.append(imp)                                        # impulse train
    out.append(rng.choice(
        np.asarray([-32768, -32767, -256, -255, -1, 0, 1, 255, 256,
                    32766, 32767], np.int16), size=n))     # byte-edge mix
    out.append(rng.integers(-32768, 32768, size=n).astype(np.int16))
    return out


def test_analyze_device_adversarial_parity():
    import jax
    import jax.numpy as jnp
    from dcsexplorer_tpu.encoder import encoder as enc

    pcms = _adversarial_pcm()
    fmax = max(enc.frames_from_pcm_raw(p).shape[0] for p in pcms)
    pad = np.zeros((len(pcms), fmax * 240 + 240), np.int16)
    for i, p in enumerate(pcms):
        pad[i, :p.size] = p

    dev_ci = np.asarray(jax.jit(
        lambda x: d94._analyze_device(x, fmax))(jnp.asarray(pad)))
    for i, p in enumerate(pcms):
        frames = enc.frames_from_pcm_raw(p)
        host_ci = enc.analyze_frames_canonical(frames)
        np.testing.assert_array_equal(
            dev_ci[i, :frames.shape[0]], host_ci,
            err_msg=f"plane decomposition diverged on adversarial input {i}")


def test_encode_files_device_end_to_end():
    """encode_files == encode_files_device, equal AND mixed lengths,
    including adversarial full-scale material (the round-4 flagship claim,
    now pinned in-suite)."""
    from dcsexplorer_tpu.encoder import encoder as enc

    rng = np.random.default_rng(5)
    t = np.arange(240 * 40) / 31250.0
    music = np.clip(
        8000 * np.sin(2 * np.pi * 440 * t)
        + 4000 * np.sin(2 * np.pi * 659.3 * t)
        + 200 * rng.standard_normal(t.size), -32768, 32767).astype(np.int16)
    adv = _adversarial_pcm()
    jobs = [
        (music, 31250),                           # musical, 40 frames
        (music[: 240 * 7 + 3], 31250),            # short, odd tail
        (adv[3], 31250),                          # alternating-sign max
        (adv[4], 31250),                          # impulse train
        (music[: 240 * 70], 31250),               # crosses a padding bucket
    ]
    params = CompressionParams()
    want = enc.encode_files(jobs, params, workers=1)
    got = enc.encode_files_device(jobs, params)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"device path diverged end-to-end on job {i}"


@pytest.mark.parametrize("matrix", ["production", "full_range"])
def test_analyze_device_int8_planes_exact_on_extremes(monkeypatch, matrix):
    """The all-int8 plane decomposition (biased low bytes, row/column-sum
    corrections) is exact for ±32768 PCM against any int16 matrix,
    including one that spans the full int16 range."""
    import jax
    from dcsexplorer_tpu.encoder import encoder as enc

    if matrix == "full_range":
        rng = np.random.default_rng(5)
        fq = rng.integers(-32768, 32768, size=(256, 255)).astype(np.int16)
        fq[0, :] = -32768
        fq[1, :] = 32767
        fq[:, 0] = -32768
        monkeypatch.setattr(enc, "_FQ", fq)
    n = 240 * 4 + 16
    pcms = [np.full(n, -32768, np.int16), np.full(n, 32767, np.int16),
            np.where(np.arange(n) % 3 == 0, -32768, 32767).astype(np.int16),
            np.random.default_rng(9).integers(-32768, 32768, size=n)
            .astype(np.int16)]
    fmax = max(enc.frames_from_pcm_raw(p).shape[0] for p in pcms)
    pad = np.zeros((len(pcms), fmax * 240 + 240), np.int16)
    for i, p in enumerate(pcms):
        pad[i, :p.size] = p
    dev_ci = np.asarray(jax.jit(lambda x: d94._analyze_device(x, fmax))(pad))
    for i, p in enumerate(pcms):
        frames = enc.frames_from_pcm_raw(p)
        np.testing.assert_array_equal(
            dev_ci[i, :frames.shape[0]], enc.analyze_frames_canonical(frames),
            err_msg=f"{matrix} matrix, input {i}")
