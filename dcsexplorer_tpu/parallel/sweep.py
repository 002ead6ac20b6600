"""Multi-chip catalog sweep: shard the batched decode over a device mesh.

Parallel dimensions (SURVEY.md §2.5):
- ``tracks``: pure data parallelism over streams/tracks — each chip decodes a
  shard of the catalog; no collectives in the main body.
- ``frames``: sequence parallelism over the frame axis within streams — the
  only cross-frame coupling is the 16-word overlap-add shift, which XLA
  lowers to a neighbor collective-permute over the ``frames`` axis.

Everything rides jax.sharding + jit: annotate in/out shardings and let XLA
insert the collectives.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import batched


def make_flat_mesh(devices=None):
    """1-D mesh over the flat frame axis (tracks × frames fused).

    The flagship flat sweep (models/flatsweep.py) packs every frame of every
    stream onto one axis, so a single 'batch' mesh axis gives combined data
    parallelism (across streams) and sequence parallelism (across frames
    within a stream) at once.
    """
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), ("batch",))


def flat_shardings(mesh):
    """in_shardings for flat_pipeline's 10 dynamic args on a flat mesh.

    The quad-window byte pool (arg 0) is replicated; every per-frame array
    shards over the flat frame axis.  The overlap-add carry shift
    (flat_pipeline's tails[:-1] concat) lowers to a neighbor
    collective-permute at shard boundaries.
    """
    repl = NamedSharding(mesh, P())
    row = NamedSharding(mesh, P("batch"))
    return (repl,) + (row,) * 9


def pad_flat(args, n_shards):
    """Pad FlatSweep args' flat frame axis to a multiple of n_shards.

    Padding rows are inert: a zero header gives band_type 0 everywhere (no
    symbols, zero output), and since the overlap carry only flows forward,
    trailing pad rows cannot perturb any real row.  Callers slice the output
    back to the original length.
    """
    args = list(args)
    N = args[1].shape[0]
    pad = (-N) % n_shards
    if pad:
        for k in range(1, 10):
            a = jnp.asarray(args[k])
            widths = [(0, 0)] * a.ndim
            widths[0] = (0, pad)
            args[k] = jnp.pad(a, widths)
    return tuple(args)


def sharded_flat_sweep(mesh, args):
    """Run the flagship flat-frame sweep sharded over the mesh.

    args: FlatSweep.args() with args[0] already expanded to quad windows
    (ops.band_decode.window_quads).  Returns pcm [N, 240] (u16 storage) with
    any padding rows stripped — bit-identical to the single-device
    flat_pipeline (asserted in tests/test_parallel.py).
    """
    from ..models import flatsweep

    N = args[1].shape[0]
    args = pad_flat(args, mesh.devices.size)
    out = NamedSharding(mesh, P("batch", None))
    fn = jax.jit(flatsweep.flat_pipeline, static_argnums=(10,),
                 in_shardings=flat_shardings(mesh), out_shardings=out)
    with mesh:
        pcm = fn(*args)
    return pcm[:N]


def make_mesh(devices=None, frame_shards=1):
    """Mesh over (tracks, frames).  frame_shards divides the device count."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    assert n % frame_shards == 0
    dev = np.array(devices).reshape(n // frame_shards, frame_shards)
    return Mesh(dev, ("tracks", "frames"))


def shard_args(mesh, args):
    """Place SweepInputs.args() onto the mesh.

    Layout: stream data and per-frame metadata shard over 'tracks'; the frame
    axis of per-frame arrays additionally shards over 'frames'.
    """
    (sb, rs, hd, fmt, sub, bt, btp, mix, vol, n_steps) = args
    sh = lambda *spec: NamedSharding(mesh, P(*spec))
    return (
        jax.device_put(sb, sh("tracks", None)),
        jax.device_put(rs, sh("tracks", "frames")),
        jax.device_put(hd, sh("tracks", None)),
        fmt, sub,
        jax.device_put(bt, sh("tracks", "frames", None)),
        jax.device_put(btp, sh("tracks", "frames", None)),
        jax.device_put(mix, sh("tracks", "frames")),
        jax.device_put(vol, sh("tracks", "frames")),
        n_steps,
    )


def sharded_sweep(mesh, args):
    """jit-compile and run the catalog sweep over the mesh.

    Returns pcm [S, F, 240] sharded over (tracks, frames).
    """
    args = shard_args(mesh, args)
    out_sharding = NamedSharding(mesh, P("tracks", "frames", None))
    fn = jax.jit(batched.batch_decode, static_argnums=(3, 4, 9),
                 out_shardings=out_sharding)
    with mesh:
        return fn(*args)


def sharded_sessions(mesh, bank, rows, mix, vol_shift):
    """Run a batch of sessions data-parallel over the mesh.

    The serving shape: B independent control traces (sessions) against one
    replicated stream bank.  rows/mix: [B, T, 8]; vol_shift: [B, T].
    Returns pcm [B, T, 240] (u16 storage), bit-identical to vmapping the
    bank decode on one device (tests/test_parallel.py).

    The bank arrays ride as explicit (replicated) jit arguments — never as
    closure captures, which would fetch them to host at trace time (see
    models/pipeline.StreamBank.bank_args).
    """
    import jax

    B = rows.shape[0]
    pad = (-B) % mesh.devices.size
    if pad:
        rows = jnp.pad(rows, ((0, pad), (0, 0), (0, 0)))
        mix = jnp.pad(mix, ((0, pad), (0, 0), (0, 0)))
        vol_shift = jnp.pad(vol_shift, ((0, pad), (0, 0)))
    row_sh = NamedSharding(mesh, P("batch"))
    repl = NamedSharding(mesh, P())
    dec = bank.decode_fn()

    def run(bank_args, r, m, v):
        pcm, _ = jax.vmap(lambda a, b, c: dec(bank_args, a, b, c))(r, m, v)
        return pcm

    bank_args = bank.bank_args()
    repl_tree = jax.tree.map(lambda _: repl, bank_args)
    fn = jax.jit(run, in_shardings=(repl_tree,) + (row_sh,) * 3,
                 out_shardings=row_sh)
    with mesh:
        return fn(bank_args, jnp.asarray(rows, jnp.int32),
                  jnp.asarray(mix, jnp.int32),
                  jnp.asarray(vol_shift, jnp.int32))[:B]
