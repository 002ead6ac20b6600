"""Native C++ host runtime validation.

The native library must agree with the Python prescan on every index
field, and its dense decode must produce bit-exact PCM through the hybrid
device stage (vs the compiled reference decoder)."""

import glob
import os

import numpy as np
import pytest

from dcsexplorer_tpu import native
from dcsexplorer_tpu.ops import prescan

from . import oracle

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets", "streams")


def _streams():
    return [open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(ASSETS, "*.dcs94")))]


def _require_native():
    if native.get_lib() is None:
        pytest.skip("native library unavailable (no compiler?)")


def test_native_index_matches_python_prescan():
    _require_native()
    for s in _streams():
        nd = native.decode_dense(s, 0, want_controls=False)
        idx = prescan.prescan94(s, 0)
        assert nd.n_frames == idx.n_frames
        assert nd.fmt_type == idx.fmt_type and nd.sub_type == idx.sub_type
        assert np.array_equal(nd.start_bit, idx.start_bit)
        assert np.array_equal(nd.end_bit, idx.end_bit)
        assert np.array_equal(nd.band_type, idx.band_type)
        assert np.array_equal(nd.band_type_prev, idx.band_type_prev)
        assert np.array_equal(np.asarray(nd.header, dtype=np.int64),
                              np.asarray(idx.header, dtype=np.int64))


def test_native_hybrid_pcm_bit_exact():
    _require_native()
    if oracle.get_lib() is None:
        pytest.skip("reference oracle unavailable")
    import jax.numpy as jnp
    from dcsexplorer_tpu.models import batched

    for s in _streams()[:2]:
        nd = native.decode_dense(s, 0, want_controls=True)
        F = nd.n_frames
        mix = jnp.full((F,), 0x549, jnp.int32)   # mixing 0x64 at volume 0x67
        vol = jnp.zeros((F,), jnp.int32)
        # the scalar runtime computes these per frame; take them from a trace
        from dcsexplorer_tpu.models.pipeline import ControlTracer
        from dcsexplorer_tpu.refdec import decoder as rd
        tr = ControlTracer()
        tr.default_volume = 0x67
        tr.init_standalone(rd.OS94)
        tr.soft_boot()
        tr.load_audio_stream(0, s, mixing_level=0x64)
        tr.trace_frames(F)
        mixes = np.zeros(F, np.int32)
        for t, entries in enumerate(tr.trace_entries):
            for (c, _, fidx, m) in entries:
                if c == 0 and fidx == t:
                    mixes[t] = m
        vols = np.asarray(tr.trace_vol_shift, np.int32)

        pcm = np.asarray(batched.hybrid_stage_device(
            jnp.asarray(nd.dense), jnp.asarray(nd.scale),
            jnp.asarray(nd.fb_idx, jnp.int32),
            jnp.asarray(nd.valid, jnp.int32).astype(bool),
            jnp.asarray(mixes), jnp.asarray(vols)))
        got = (((pcm & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int16).reshape(-1)

        ref = oracle.OracleDecoder(os_version=oracle.OS94, default_volume=0x67)
        ref.load_stream(s, channel=0, mixing_level=0x64)
        golden = ref.next_samples(F * 240)
        assert np.array_equal(golden, got), "hybrid PCM mismatch"


def _idx93_fields(a, b):
    for fld in ("kind", "width", "n_samp", "bit_start", "out_start",
                "out_inc", "scale", "prv_in", "prv_dl", "end_bit"):
        ga, gb = getattr(a, fld), getattr(b, fld)
        assert np.array_equal(ga, gb), f"93 index field {fld} differs"


def test_native_index93_matches_python():
    _require_native()
    from dcsexplorer_tpu import native as nat
    from dcsexplorer_tpu.ops import decode93
    from .test_format93 import build_stream93_fmt0, build_stream93_fmt1

    for builder in (build_stream93_fmt0, build_stream93_fmt1):
        for seed in range(6):
            s = builder(n_frames=20, n_bands=9, seed=seed)
            got = nat.index93(s, 0)
            assert got is not None
            ref = decode93.prescan93(s, 0, prefer_native=False)
            assert got.n_frames == ref.n_frames
            assert got.fmt_type == ref.fmt_type
            _idx93_fields(got, ref)


def test_native_index93a_matches_python():
    _require_native()
    from dcsexplorer_tpu import native as nat
    from dcsexplorer_tpu.ops import decode93a
    from .test_format93 import build_stream93a_type1

    for selector in (0, 1, 2, 3):
        for seed in range(4):
            s = build_stream93a_type1(n_frames=16, n_bands=12,
                                      selector=selector, seed=seed)
            got = nat.index93a(s, 0)
            assert got is not None
            ref = decode93a.prescan93a(s, 0, prefer_native=False)
            assert got.n_frames == ref.n_frames
            assert got.selector == ref.selector
            for fld in ("bits", "bit_start", "scale32", "end_bit"):
                assert np.array_equal(getattr(got, fld), getattr(ref, fld)), \
                    f"93a index field {fld} differs"


def test_library_path_is_keyed_on_the_host(monkeypatch):
    """A library built for one CPU or compiler is never loaded on another:
    its file name changes with either, and the loaded library is the one
    keyed for this host."""
    here = native.lib_path()
    monkeypatch.setattr(native, "_host_cpu", lambda: "model name : other")
    elsewhere = native.lib_path()
    assert here != elsewhere
    assert os.path.basename(here).startswith("libdcsnative-")
    monkeypatch.undo()
    lib = native.get_lib()
    assert lib is not None and lib._name == native.lib_path()
