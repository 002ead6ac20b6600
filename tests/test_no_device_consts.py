"""Guard: no device program may close over an eager jax.Array.

A traced function that captures a concrete ``jax.Array`` (a module-level
``jnp.asarray`` constant, a ``self.<array>`` attribute, a closure cell)
forces a device->host literal fetch when the capture is lowered into the
HLO, on every backend, and inlines the array into the executable as a
constant — bloating it and defeating jit caching.

The rule: constants used inside traced code are numpy (XLA inlines them
at trace time with no fetch); runtime arrays are explicit jit ARGUMENTS
(device-resident args transfer nothing per call).

This test traces every hot device program via ``jax.make_jaxpr`` and
asserts its captured consts contain no ``jax.Array``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def assert_no_device_consts(fn, *args, **kwargs):
    closed = jax.make_jaxpr(lambda *a: fn(*a, **kwargs))(*args)
    bad = [c for c in closed.consts if isinstance(c, jax.Array)]
    assert not bad, (
        f"{getattr(fn, '__name__', fn)} captured {len(bad)} eager "
        f"jax.Array const(s) {[b.shape for b in bad]} — pass them as "
        f"arguments instead (they are fetched to host at lowering and "
        f"inlined as constants)")


def _flat_args(n=4):
    pool = jnp.zeros((64, 8), jnp.uint32)
    sb = jnp.zeros(n, jnp.int32)
    hdr = jnp.full((n, 16), 0x7F, jnp.int32)
    v16 = jnp.zeros((n, 16), jnp.int32)
    v1 = jnp.zeros(n, jnp.int32)
    return (pool, sb, hdr, v1, v1, v16, v16, v1, v1,
            jnp.zeros(n, bool))


def test_flat_pipeline_no_device_consts():
    from dcsexplorer_tpu.models import flatsweep
    assert_no_device_consts(
        lambda *a: flatsweep.flat_pipeline(*a, 8), *_flat_args())


def test_batched_decode_no_device_consts():
    from dcsexplorer_tpu.models import batched
    S, F = 2, 3
    sb = jnp.zeros((S, 64), jnp.int32)
    rs = jnp.zeros((S, F), jnp.int32)
    hd = jnp.full((S, 16), 0x7F, jnp.int32)
    bt = jnp.zeros((S, F, 16), jnp.int32)
    mix = jnp.zeros((S, F), jnp.int32)
    vol = jnp.zeros((S, F), jnp.int32)
    assert_no_device_consts(
        lambda *a: batched.batch_decode(a[0], a[1], a[2], 0, 0, a[3],
                                        a[4], a[5], a[6], 8),
        sb, rs, hd, bt, bt, mix, vol)


def test_bank94_decode_no_device_consts():
    from dcsexplorer_tpu.models import pipeline as pl
    R, T = 5, 4
    bank_args = (jnp.zeros((R, 256), jnp.int32),
                 jnp.zeros((R, 256), jnp.int32),
                 jnp.zeros(R, jnp.int32))
    rows = jnp.zeros((T, 8), jnp.int32)
    mix = jnp.zeros((T, 8), jnp.int32)
    vol = jnp.zeros(T, jnp.int32)
    assert_no_device_consts(pl.device_decode, bank_args, rows, mix, vol)


def test_bank93_decode_no_device_consts():
    from dcsexplorer_tpu.models import pipeline as pl
    from dcsexplorer_tpu.ops import decode93, decode93a
    R, T = 5, 4
    idx93 = {k: jnp.zeros((R,) + s, jnp.int32) for k, s in {
        "frame_word": (), "kind": (16,), "width": (16,), "n_samp": (16,),
        "bit_start": (16,), "out_start": (16,), "out_inc": (16,),
        "scale": (16,), "prv_in": (16,), "prv_dl": (16,)}.items()}
    idx93a = {k: jnp.zeros((R,) + s, jnp.int32) for k, s in {
        "frame_word": (), "bits": (decode93a.N_BANDS,),
        "bit_start": (decode93a.N_BANDS,),
        "scale32": (decode93a.N_BANDS,)}.items()}
    bank93 = (jnp.zeros((64, 8), jnp.uint32), idx93, idx93a)
    rows = jnp.zeros((T, 8), jnp.int32)
    mix = jnp.zeros((T, 8), jnp.int32)
    vol = jnp.zeros(T, jnp.int32)
    assert_no_device_consts(pl.device_decode93, bank93, rows, mix, vol)


def test_stream_bank_jitted_no_device_consts():
    """The bank object's own decode_fn must trace clean (this is the
    function StreamBank.jitted() compiles)."""
    from dcsexplorer_tpu.models import romplay
    from .test_romplay import _rom_set

    rs = _rom_set()
    bank = romplay.build_rom_bank(rs)
    T = 3
    rows = jnp.zeros((T, 8), jnp.int32)
    mix = jnp.zeros((T, 8), jnp.int32)
    vol = jnp.zeros(T, jnp.int32)
    assert_no_device_consts(bank.decode_fn(), bank.bank_args(),
                            rows, mix, vol)


def test_encoder_device_no_device_consts():
    from dcsexplorer_tpu.encoder import device94
    from dcsexplorer_tpu.encoder.encoder import CompressionParams

    rng = np.random.default_rng(3)
    ci = rng.integers(-4000, 4000, (70, 255)).astype(np.int32)
    params = CompressionParams()
    slots = device94._select_formats(params)
    setups, arrs = device94.setup_compact([ci], params, slots)
    fmax = device94._bucket(ci.shape[0])
    cib = np.zeros((1, fmax, 255), np.int32)
    cib[0, :ci.shape[0]] = ci
    nf = np.asarray([ci.shape[0]], np.int32)
    tabs = device94._static_format_tables(list(slots))

    def run_ci(ci_, nf_, keep, thr, dlim, cape, hdr_scale, wanted):
        mask = (jnp.arange(ci_.shape[1], dtype=jnp.int32)[None, :]
                < nf_[:, None])
        return jax.vmap(
            lambda c, m, k, h, w: device94._encode_all(
                c, m, int(arrs["sil_max"]), k, thr, dlim, cape, h, w, tabs)
        )(ci_, mask, keep, hdr_scale, wanted)

    assert_no_device_consts(
        run_ci, jnp.asarray(cib), jnp.asarray(nf), jnp.asarray(arrs["keep"]),
        jnp.asarray(arrs["thr"]), jnp.asarray(arrs["dlim"]),
        jnp.asarray(arrs["cape"]), jnp.asarray(arrs["hdr_scale"]),
        jnp.asarray(arrs["wanted"]))

    # the PCM-input program (analysis matmul on device) must trace clean too
    pcm = np.zeros((1, fmax * 240 + 240), np.int16)
    def run_pcm(pcm_, nf_, keep, thr, dlim, cape, hdr_scale, wanted):
        ci_ = device94._analyze_device(pcm_, fmax)
        return run_ci(ci_, nf_, keep, thr, dlim, cape, hdr_scale, wanted)
    assert_no_device_consts(
        run_pcm, jnp.asarray(pcm), jnp.asarray(nf),
        jnp.asarray(arrs["keep"]), jnp.asarray(arrs["thr"]),
        jnp.asarray(arrs["dlim"]), jnp.asarray(arrs["cape"]),
        jnp.asarray(arrs["hdr_scale"]), jnp.asarray(arrs["wanted"]))
