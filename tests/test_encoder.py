"""Encoder round-trip quality and cross-decoder validity.

The encoder's streams must (a) decode identically in this framework and in
the compiled reference decoder, (b) reconstruct the source with quality at
least matching the reference encoder's own round trip, and (c) follow the
reference's level convention (≈0.48× at standard settings).
"""

import numpy as np
import pytest

from dcsexplorer_tpu.encoder import encoder as enc
from dcsexplorer_tpu.encoder.resample import resample
from dcsexplorer_tpu.refdec.decoder import OS94, ReferenceDecoder

from . import oracle


def _signal(seconds=0.8, seed=9):
    rng = np.random.default_rng(seed)
    t = np.arange(int(31250 * seconds)) / 31250.0
    sig = (7000 * np.sin(2 * np.pi * 440 * t)
           + 2500 * np.sin(2 * np.pi * 1870 * t)
           + 500 * rng.standard_normal(t.size))
    env = np.minimum(1.0, t * 12) * np.minimum(1.0, (t[-1] - t) * 12)
    return np.clip(sig * env, -32000, 32000).astype(np.int16)


def _decode_mine(stream, n_frames):
    dec = ReferenceDecoder()
    dec.default_volume = 255
    dec.init_standalone(OS94)
    dec.soft_boot()
    dec.load_audio_stream(0, stream, mixing_level=0x64)
    return np.array(dec.next_samples(n_frames * 240), dtype=np.int16)


def _lag_gain_snr(out, src):
    n = min(out.size, src.size)
    o, s = out[:n].astype(np.float64), src[:n].astype(np.float64)
    c = np.correlate(o, s, "full")
    lag = int(np.argmax(np.abs(c))) - (n - 1)
    if lag >= 0:
        o2, s2 = o[lag:], s[:n - lag]
    else:
        o2, s2 = o[:n + lag], s[-lag:]
    g = np.dot(o2, s2) / np.dot(s2, s2)
    err = o2 - g * s2
    return lag, g, 10 * np.log10(np.sum((g * s2) ** 2) / np.sum(err ** 2))


def test_roundtrip_quality_and_cross_decoder():
    pcm = _signal()
    # keep all bands for the quality check (the default 0.97 power cutoff
    # intentionally discards low-power bands, same as the reference).
    # Type 0 spends more bits for transparency; the default wildcard picks
    # the smallest format (type 1 subtype 3, like the reference default),
    # which trades a little SNR for ~30% smaller streams.
    stream, nf = enc.encode_pcm(
        pcm, enc.CompressionParams(power_band_cutoff=1.0,
                                   stream_format_type=0))
    out = _decode_mine(stream, nf)

    lag, gain, snr = _lag_gain_snr(out, pcm)
    assert abs(lag) <= 16
    assert 0.4 < gain < 0.56, f"level convention drifted: gain={gain}"
    assert snr > 28, f"round-trip SNR too low: {snr:.1f} dB"

    stream_w, nf_w = enc.encode_pcm(
        pcm, enc.CompressionParams(power_band_cutoff=1.0))
    assert len(stream_w) <= len(stream)
    _, _, snr_w = _lag_gain_snr(_decode_mine(stream_w, nf_w), pcm)
    assert snr_w > 23, f"wildcard-format SNR too low: {snr_w:.1f} dB"

    # default (lossy-cutoff) settings still reach a reasonable floor
    stream_d, nf_d = enc.encode_pcm(pcm)
    _, _, snr_d = _lag_gain_snr(_decode_mine(stream_d, nf_d), pcm)
    assert snr_d > 14, f"default-settings SNR too low: {snr_d:.1f} dB"

    if oracle.get_lib() is not None:
        ref = oracle.OracleDecoder(os_version=oracle.OS94, default_volume=255)
        ref.load_stream(stream, channel=0, mixing_level=0x64)
        rout = ref.next_samples(nf * 240)
        assert np.array_equal(rout, out), \
            "reference decoder disagrees with ours on our encoder's stream"


def test_quality_vs_reference_encoder():
    if oracle.get_lib() is None:
        pytest.skip("reference oracle unavailable")
    pcm = _signal(seed=21)
    my_stream, my_nf = enc.encode_pcm(pcm)
    my_out = _decode_mine(my_stream, my_nf)
    _, _, my_snr = _lag_gain_snr(my_out, pcm)

    ref_stream, ref_nf = oracle.encode(pcm)
    ref = oracle.OracleDecoder(os_version=oracle.OS94, default_volume=255)
    ref.load_stream(ref_stream, channel=0, mixing_level=0x64)
    ref_out = ref.next_samples(ref_nf * 240)
    _, _, ref_snr = _lag_gain_snr(ref_out, pcm)

    assert my_snr >= ref_snr - 1.0, (
        f"my encoder {my_snr:.1f} dB vs reference {ref_snr:.1f} dB")
    assert len(my_stream) <= len(ref_stream), (
        f"my stream larger: {len(my_stream)} vs {len(ref_stream)} bytes")


def test_encoder_edge_cases():
    # silence
    stream, nf = enc.encode_pcm(np.zeros(1000, dtype=np.int16))
    out = _decode_mine(stream, nf)
    assert np.abs(out).max() == 0
    # tiny input (sub-frame)
    stream, nf = enc.encode_pcm(np.ones(37, dtype=np.int16) * 1000)
    assert nf == 1
    _decode_mine(stream, nf)
    # full-scale square wave must not produce invalid streams
    sq = (np.tile([32000, -32000], 2000)).astype(np.int16)
    stream, nf = enc.encode_pcm(sq)
    out = _decode_mine(stream, nf)
    assert np.abs(out.astype(np.int32)).max() > 4000


def test_resampler():
    t48 = np.arange(48000) / 48000.0
    x48 = np.sin(2 * np.pi * 1000 * t48).astype(np.float32)
    y = resample(x48, 48000, 31250)
    assert abs(y.size - 31250) <= 2
    t31 = np.arange(y.size) / 31250.0
    ref = np.sin(2 * np.pi * 1000 * t31)
    # ignore filter edges
    seg = slice(200, y.size - 200)
    err = y[seg] - ref[seg]
    snr = 10 * np.log10(np.sum(ref[seg] ** 2) / np.sum(err ** 2))
    assert snr > 40, f"resampler SNR {snr:.1f} dB"


def test_encode_via_rate_conversion():
    t = np.arange(22050) / 22050.0
    pcm = (8000 * np.sin(2 * np.pi * 500 * t)).astype(np.int16)
    stream, nf = enc.encode_pcm(pcm, sample_rate=22050)
    out = _decode_mine(stream, nf)
    # one second of audio at either rate
    assert abs(out.size - 31250) < 600
    assert np.abs(out.astype(np.int32)).max() > 1500


def test_all_formats_cross_decoder_and_device():
    """Every emitted stream format — {type 0,1} × {subtype 0,3} — must
    decode bit-exactly in the compiled reference decoder AND in the device
    flat-sweep pipeline."""
    if oracle.get_lib() is None:
        pytest.skip("reference oracle unavailable")
    from dcsexplorer_tpu.models import flatsweep

    pcm = _signal(seconds=0.4, seed=33)
    streams = []
    for (ty, su) in [(0, 0), (0, 3), (1, 0), (1, 3)]:
        s, _ = enc.encode_pcm(pcm, enc.CompressionParams(
            stream_format_type=ty, stream_format_subtype=su))
        streams.append(bytes(s))
    # header flag bits (stream bytes 2-4 = header[0..2]) reflect the
    # requested format: [0]bit7 = type, [1]/[2]bit7 = subtype bits 1/0
    flags = [((s[2] >> 7) & 1, ((s[3] >> 6) & 2) | ((s[4] >> 7) & 1))
             for s in streams]
    assert flags == [(0, 0), (0, 3), (1, 0), (1, 3)]

    sw = flatsweep.FlatSweep(streams).pack()
    out = flatsweep.run_flat(sw)
    pos = 0
    for k, s in enumerate(streams):
        nf = (s[0] << 8) | s[1]
        ref = oracle.OracleDecoder(os_version=oracle.OS94, default_volume=0x67)
        ref.load_stream(s, channel=0, mixing_level=0x64)
        golden = ref.next_samples(nf * 240)
        got = out[pos:pos + nf * 240]
        assert np.array_equal(golden, got), f"format #{k} device mismatch"
        pos += nf * 240


def test_93_encoder_roundtrip_and_cross_decoder():
    """The 1993-format encoder's streams must decode identically in the
    scalar decoder, the compiled reference decoder, and the device 93 kernel,
    at reasonable quality for both major types."""
    from dcsexplorer_tpu.refdec.decoder import OS93A, OS93B

    pcm = _signal(seconds=0.4, seed=77)
    for (osv, ty) in [(2, 0), (2, 1), (1, 0)]:     # OS93B t0/t1, OS93A t0
        stream, nf = enc.encode_pcm(pcm, enc.CompressionParams(
            stream_format_type=ty, power_band_cutoff=1.0), os_version=osv)
        dec = ReferenceDecoder()
        dec.default_volume = 255
        dec.init_standalone(osv)
        dec.soft_boot()
        dec.load_audio_stream(0, stream, mixing_level=0x64)
        out = np.array(dec.next_samples(nf * 240), dtype=np.int16)
        lag, gain, snr = _lag_gain_snr(out, pcm)
        assert abs(lag) <= 16
        assert 0.4 < gain < 0.56, f"93 level convention: gain={gain}"
        assert snr > 20, f"93 (os={osv},t={ty}) SNR too low: {snr:.1f} dB"

        if oracle.get_lib() is not None:
            ref = oracle.OracleDecoder(os_version=osv, default_volume=255)
            ref.load_stream(stream, channel=0, mixing_level=0x64)
            rout = ref.next_samples(nf * 240)
            assert np.array_equal(rout, out), \
                f"reference decoder disagrees on 93 (os={osv},t={ty})"

    # OS93a Type 1 has no encoder (matching the reference)
    with pytest.raises(ValueError):
        from dcsexplorer_tpu.encoder import encoder93
        encoder93.encode_stream93(np.zeros((2, 254)), 1,
                                  enc.CompressionParams(), os93a=True)


def test_93_encoder_device_kernel():
    """93-encoded streams decode bit-exactly through the device 93 kernel."""
    if oracle.get_lib() is None:
        pytest.skip("reference oracle unavailable")
    from .test_format93 import _device_decode93
    pcm = _signal(seconds=0.3, seed=78)
    for ty in (0, 1):
        stream, nf = enc.encode_pcm(pcm, enc.CompressionParams(
            stream_format_type=ty), os_version=2)
        ref = oracle.OracleDecoder(os_version=2, default_volume=255)
        ref.load_stream(stream, channel=0, mixing_level=0x64)
        golden = ref.next_samples(nf * 240)
        got = _device_decode93(stream, nf)
        assert np.array_equal(golden, got), f"93 device mismatch (t={ty})"


def test_encode_files_batch():
    """Data-parallel multi-file encoding returns per-file results identical
    to individual encodes (process-parallel on multicore hosts)."""
    jobs = [(_signal(seconds=0.3, seed=s), 31250) for s in (1, 2)]
    out = enc.encode_files(jobs, workers=2)
    for (pcm, rate), (stream, nf) in zip(jobs, out):
        single = enc.encode_pcm(pcm, sample_rate=rate)
        assert single[0] == stream and single[1] == nf


def test_transcode_stream_version_mismatch():
    """A .dcs stream of one family re-encodes into another with the
    playback level preserved (reference EncodeDCSFile semantics)."""
    from dcsexplorer_tpu.encoder import encoder as enc
    from dcsexplorer_tpu.refdec.decoder import OS93B, OS94

    t = np.arange(240 * 12) / 31250.0
    src = (6000.0 * np.sin(2 * np.pi * 523.0 * t)).astype(np.float32)
    s93, _ = enc.encode_pcm(src, enc.CompressionParams(), os_version=OS93B)
    s94, nf = enc.transcode_stream(s93, OS93B, OS94)
    assert nf == 12
    # decode both and compare playback levels: the transcode must not
    # compound the runtime's nominal ~0.48x playback gain
    p93 = enc._decode_stream_pcm(s93, OS93B)
    p94 = enc._decode_stream_pcm(s94, OS94)
    r93 = float(np.sqrt(np.mean(p93 ** 2)))
    r94 = float(np.sqrt(np.mean(p94 ** 2)))
    assert r93 > 100
    assert 0.7 < r94 / r93 < 1.4, (r93, r94)


def test_alternative_analysis_transform():
    """The butterfly analysis (the decoder transform's passes inverted in
    closed form — counterpart of the reference's independent second DFT
    algorithm, DCSEncoder.cpp:1102-1216) must agree with the production
    pinv analysis on the transmittable component, and streams encoded with
    it must round-trip with equivalent quality."""
    from dcsexplorer_tpu.encoder import analysis as A

    rng = np.random.default_rng(4)
    coef = (rng.standard_normal((6, 255)) * 2000).astype(np.float32)
    time = coef @ A.decoder_matrix()
    # exact-inverse property on the decoder's range
    rec = A.analyze_frames_butterfly(time)
    assert np.abs(rec - coef).max() < 0.05
    # wire-domain agreement on raw (off-range) audio frames
    raw = rng.standard_normal((4, 256)) * 8000
    ta = A.analyze_frames(raw) @ A.decoder_matrix()
    tb = A.analyze_frames_butterfly(raw) @ A.decoder_matrix()
    assert np.abs(ta - tb).max() < 1e-4 * np.abs(ta).max() + 0.05
    # "dual" cross-check mode returns the production result
    assert np.allclose(A.analyze_frames(time, algorithm="dual"),
                       A.analyze_frames(time))

    pcm = _signal()
    p_alt = enc.CompressionParams(power_band_cutoff=1.0,
                                  stream_format_type=0,
                                  analysis_transform="butterfly")
    p_std = enc.CompressionParams(power_band_cutoff=1.0,
                                  stream_format_type=0)
    s_alt, nf = enc.encode_pcm(pcm, p_alt)
    s_std, _ = enc.encode_pcm(pcm, p_std)
    out_alt = _decode_mine(s_alt, nf)
    out_std = _decode_mine(s_std, nf)
    _, _, snr_alt = _lag_gain_snr(out_alt, pcm)
    _, _, snr_std = _lag_gain_snr(out_std, pcm)
    assert snr_alt > snr_std - 0.5, (snr_alt, snr_std)
