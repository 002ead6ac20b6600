"""Multi-chip sharding correctness: the sweep sharded over a (tracks,
frames) mesh must produce BIT-IDENTICAL PCM to the single-device run —
sequence parallelism over frames must not perturb the overlap-add
collective-permute.  Runs on the virtual 8-device CPU mesh
(tests/conftest.py sets xla_force_host_platform_device_count=8)."""

import glob
import os

import numpy as np
import pytest

import jax

from dcsexplorer_tpu.models import batched, flatsweep
from dcsexplorer_tpu.ops import band_decode as bd
from dcsexplorer_tpu.parallel import sweep

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets", "streams")


LEGACY = ("chirpy", "noise_sweep", "sine_mix_1s", "tone_low")


def _inputs(pad_frames_to=None):
    # the padded model batches one format family (models/batched.py:46):
    # use the single-format legacy corpus
    streams = [open(os.path.join(ASSETS, f"{n}.dcs94"), "rb").read()
               for n in LEGACY]
    streams = streams * 2           # 8 streams → shards over 'tracks'
    return batched.SweepInputs(streams)


@pytest.mark.parametrize("frame_shards", [1, 2, 4])
def test_sharded_sweep_bit_exact(frame_shards):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    inputs = _inputs()
    args = list(inputs.args())
    # pad the frame axis to a multiple of the frame shards
    F = args[1].shape[1]
    pad = (-F) % (frame_shards * 1)
    if pad:
        import jax.numpy as jnp
        for k in (1, 5, 6, 7, 8):
            widths = [(0, 0)] * args[k].ndim
            widths[1] = (0, pad)
            args[k] = jnp.pad(args[k], widths)
    args = tuple(args)

    single = np.asarray(jax.jit(batched.batch_decode,
                                static_argnums=(3, 4, 9))(*args))

    mesh = sweep.make_mesh(jax.devices()[:8], frame_shards=frame_shards)
    sharded = np.asarray(sweep.sharded_sweep(mesh, args))

    assert sharded.shape == single.shape
    assert np.array_equal(sharded, single), (
        f"sharded (frames={frame_shards}) diverged from single-device")


def test_sharded_flat_sweep_bit_exact():
    """The FLAGSHIP flat sweep sharded over the flat-frame axis must be
    bit-identical to the single-device flat pipeline — including the
    overlap-add carry crossing shard boundaries and padding rows being
    inert.  The asset catalog's total frame count is not a multiple of 8,
    so the pad_flat path is exercised too."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    streams = [open(p, "rb").read()
               for p in sorted(glob.glob(os.path.join(ASSETS, "*.dcs94")))]
    streams = streams * 3
    sw = flatsweep.FlatSweep(streams).pack()

    single = flatsweep.run_flat(sw)

    args = list(sw.args())
    args[0] = bd.window_quads(args[0])
    mesh = sweep.make_flat_mesh(jax.devices()[:8])
    pcm = np.asarray(sweep.sharded_flat_sweep(mesh, tuple(args)))
    sharded = (((pcm & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int16).reshape(-1)

    assert sharded.shape == single.shape
    assert np.array_equal(sharded, single), (
        "sharded flat sweep diverged from single-device")


def test_sharded_sessions_bit_exact():
    """Session serving sharded over the mesh (pure DP over sessions) must
    equal the single-device vmapped decode bit-for-bit — including a batch
    that does not divide the device count (padding rows)."""
    from dcsexplorer_tpu.models import pipeline as pl, romplay
    from dcsexplorer_tpu.compiler import romgen as g
    from dcsexplorer_tpu.refdec import decoder as rd
    from dcsexplorer_tpu.rom import zipload
    import jax.numpy as jnp

    streams = [open(os.path.join(ASSETS, f"{n}.dcs94"), "rb").read()
               for n in LEGACY[:3]]
    spec = g.RomSpec(os_version=rd.OS94, num_channels=6)
    spec.streams = {f"s{i}": d for i, d in enumerate(streams)}
    spec.tracks = [g.TrackSpec(0, steps=[g.op_end()])]
    for i in range(3):
        spec.tracks.append(g.TrackSpec(i + 1, channel=i, steps=[
            g.op_mix(0, i, 0x40 + 4 * i),
            g.op_play(i, f"s{i}", repeat=0),
            g.op_wait_forever(),
        ]))
    rs, _ = zipload.load_zip_data(g.RomBuilder(spec).build_zip())
    rs.check()
    bank = romplay.build_rom_bank(rs)

    B, T = 6, 40                     # 6 sessions on 8 devices → padding
    rows, mixes, vols = [], [], []
    for b in range(B):
        tr = pl.ControlTracer()
        tr.load_rom_set(rs)
        tr.soft_boot()

        def start(dec, b=b):
            for t in range(1, 4):
                dec.write_data_port(0x00)
                dec.write_data_port(t)
        tr.trace_frames(T, events={(b % 5): start})
        r, m, v = pl.assemble_controls(tr, bank)
        rows.append(r)
        mixes.append(m)
        vols.append(v)
    rows = np.stack(rows)
    mixes = np.stack(mixes)
    vols = np.stack(vols)

    dec = bank.decode_fn()
    single = np.asarray(jax.jit(lambda ba, r, m, v: jax.vmap(
        lambda a, b_, c: dec(ba, a, b_, c)[0])(r, m, v))(
        bank.bank_args(), jnp.asarray(rows), jnp.asarray(mixes),
        jnp.asarray(vols)))

    mesh = sweep.make_flat_mesh()
    sharded = np.asarray(sweep.sharded_sessions(
        mesh, bank, rows, mixes, vols))
    assert np.array_equal(sharded, single)
