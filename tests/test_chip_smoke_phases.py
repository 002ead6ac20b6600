"""chip_smoke.py's serve, cli and encode phases at tiny sizes on the CPU."""

import pytest

import chip_smoke as cs
from dcsexplorer_tpu.refdec import decoder as rd


@pytest.fixture(scope="module")
def pool():
    with cs.reference_pool(2) as p:
        yield p


def test_serve_phase_tiny(pool):
    rom94s, _ = cs.make_rom(rd.OS94, cs._assets("*.dcs94"), 256 * 1024, 2,
                            seed=1, max_frames=3000)
    row = cs.phase_serve(rom94s, 4, 40, 5, 1, 0, pool, depth=3)
    assert row["ok"] and row["batches"] == 5
    assert row["compared_sessions"] == 5 and row["compared_frames"] == 200


def test_cli_phase_tiny():
    small, _ = cs.make_rom(rd.OS94, cs._assets("*.dcs94")[:2], 512 * 1024, 1,
                           seed=0, max_streams=2)
    row = cs.phase_cli(small, 40)
    assert row["ok"] and row["wav_bytes"] > 44
    samples, frames = row["validate"].split(" (")
    assert int(samples) == 240 * int(frames.split()[0]) > 0


def test_encode_phase_tiny(pool):
    row = cs.phase_encode(2, 0.3, 44100, 0, pool)
    assert row["ok"] and row["byte_identical"]
    assert not row["workers_started_jax"]
    assert row["compared_frames"] > 0
    assert set(row["int8_dots"]) == {"cublas", "triton_gemm", "loop_dot"}
