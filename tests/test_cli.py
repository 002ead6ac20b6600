"""Explorer CLI smoke tests driven through the real command-line surface."""

import os
import subprocess
import sys

import pytest

from dcsexplorer_tpu.compiler import romgen

from .test_romgen import _make_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def rom_zip(tmp_path_factory):
    path = tmp_path_factory.mktemp("rom") / "synth.zip"
    path.write_bytes(romgen.RomBuilder(_make_spec()).build_zip())
    return str(path)


def _run(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "dcsexplorer_tpu.tools.explorer", *args],
        capture_output=True, text=True, env=env, timeout=600)


def test_cli_info(rom_zip):
    r = _run([rom_zip])
    assert r.returncode == 0, r.stderr
    assert "ROM check:   OK" in r.stdout
    assert "Tracks:      8" in r.stdout


def test_cli_listings(rom_zip):
    r = _run([rom_zip, "--tracks", "--streams", "--ditables"])
    assert r.returncode == 0, r.stderr
    assert "Track $0001" in r.stdout
    assert "kbps" in r.stdout
    assert "Table $01" in r.stdout


def test_cli_validate(rom_zip):
    r = _run([rom_zip, "--validate", "--max-track-frames", "60",
              "--platform", "cpu"])
    assert r.returncode == 0, r.stderr
    assert "Validation Succeeded" in r.stdout


def test_cli_bad_rom(tmp_path):
    bad = tmp_path / "bad.zip"
    bad.write_bytes(b"PK\x05\x06" + b"\x00" * 18)   # empty zip
    r = _run([str(bad)])
    assert r.returncode == 2
    assert "error" in r.stderr


def test_cli_missing_file():
    r = _run(["/nonexistent/rom.zip"])
    assert r.returncode == 2

def test_validate_diagnostics_on_forced_mismatch(rom_zip, tmp_path, monkeypatch):
    """A forced PCM mismatch must produce a debuggable log: diff-run
    aggregation, both decoders' per-frame sample dumps, and the recent
    data-port command history (reference: DCSExplorer.cpp:1425-1447,
    1513-1566)."""
    from dcsexplorer_tpu.models import romplay
    from dcsexplorer_tpu.rom import zipload
    from dcsexplorer_tpu.tools import explorer

    real_autoplay = romplay.autoplay

    def corrupted(*a, **kw):
        pcm, schedule, tracer = real_autoplay(*a, **kw)
        pcm = pcm.copy()
        pcm[240 * 3 + 17] ^= 0x55       # frame 3
        pcm[240 * 4: 240 * 6] ^= 0x2A   # frames 4-5 (one run with frame 3)
        pcm[240 * 9 + 1] ^= 0x01        # frame 9 (separate run)
        return pcm, schedule, tracer

    monkeypatch.setattr(romplay, "autoplay", corrupted)
    rs, _ = zipload.load_zip_file(rom_zip)
    log = tmp_path / "validate.log"
    rc = explorer.cmd_validate(rs, 0x67, 60, log_path=str(log))
    assert rc == 1
    text = log.read_text()
    assert "Validation FAILED" in text
    assert "2 diff runs" in text
    assert "frames 3..5" in text and "frames 9..9" in text
    # both decoders' sample dumps for the differing frames
    assert "Frame 3:" in text
    assert "scalar[  0]" in text and "device[  0]" in text
    # the repro command history
    assert "recent data-port commands" in text
    assert "play track $" in text


def test_validate_diagnostics_on_port_mismatch(rom_zip, tmp_path, monkeypatch):
    """A data-port history divergence is reported with both byte streams."""
    from dcsexplorer_tpu.models import romplay
    from dcsexplorer_tpu.rom import zipload
    from dcsexplorer_tpu.tools import explorer

    real_autoplay = romplay.autoplay

    def port_corrupted(*a, **kw):
        pcm, schedule, tracer = real_autoplay(*a, **kw)
        tracer.host.rx.append(0xEE)     # phantom extra DCS->host byte
        return pcm, schedule, tracer

    monkeypatch.setattr(romplay, "autoplay", port_corrupted)
    rs, _ = zipload.load_zip_file(rom_zip)
    log = tmp_path / "validate.log"
    rc = explorer.cmd_validate(rs, 0x67, 60, log_path=str(log))
    assert rc == 1
    text = log.read_text()
    assert "Data port diverges at byte" in text
    assert "EE" in text
