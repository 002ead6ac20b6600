"""Unit harnesses for the OS94 decoding firmware (compiler/firmware94.py).

Each test loads the assembled firmware into a bare ADSP-2105 core with the
DCS-93 board memory map stubbed in, calls one firmware routine directly,
and compares the result with the scalar reference decoder (refdec/) —
the same oracle the device kernels are validated against.  The full
two-backend integration (compiler ROM → emulator backend → PCM parity)
lives in tests/test_emu_decode.py.
"""

import numpy as np
import pytest

from dcsexplorer_tpu.compiler import firmware94 as FW
from dcsexplorer_tpu.compiler.firmware94 import (BUF, CH, FB, MIXA, OVLB,
                                                 ST, SYM, TAB, TABLE_WORDS,
                                                 C_CVOL, C_MMULT, C_MOVR,
                                                 C_SRC, C_STOP, C_TCTR,
                                                 C_TRKHI, S_BT, S_CURHI,
                                                 S_CURLO, S_FCTR, S_HDR,
                                                 S_HDRHI, S_HDRLO, S_LCTR,
                                                 S_NB, S_NEEDI, S_NFRM,
                                                 S_PLAY, S_SRTHI, S_SRTLO,
                                                 S_WHI, S_WLO)
from dcsexplorer_tpu.emu.adsp2105 import ADSP2105
from dcsexplorer_tpu.refdec.bitreader import BitReader, PaddedView

TRAP_ADDR = 0x700


class Harness:
    """Bare-core firmware harness with the DCS-93 ROM window stubbed."""

    def __init__(self, rom=b""):
        boot, overlay, syms = FW.build_decoder_firmware()
        self.syms = syms
        self.rom = bytearray(rom)
        self.bank = 0
        cpu = ADSP2105(read_dm=self._rd, write_dm=self._wr)
        cpu.pm[:len(boot)] = boot
        cpu.pm[FW.OVERLAY_PM:FW.OVERLAY_PM + len(overlay)] = overlay
        cpu.pm[TRAP_ADDR] = 0x010000
        for k, w in enumerate(TABLE_WORDS):
            cpu.dm[TAB + k] = w
        # the init-time DAG invariants
        for k, v in ((0, 0), (1, 1), (2, -1), (3, 0), (4, 0), (5, 0),
                     (6, 1), (7, 0)):
            cpu.m[k] = v
        cpu.i[5] = 0x3000
        cpu.dm[SYM["CURBANK"]] = 0xFFFF
        self.cpu = cpu

    def _rd(self, addr):
        addr &= 0x3FFF
        if 0x2000 <= addr <= 0x2FFF:
            p = (self.bank << 12) + (addr - 0x2000)
            return self.rom[p] if p < len(self.rom) else 0xFF
        return self.cpu.dm[addr]

    def _wr(self, addr, data):
        addr &= 0x3FFF
        self.cpu.dm[addr] = data & 0xFFFF
        if addr == 0x3000:
            self.bank = data

    def call(self, label, max_steps=2_000_000):
        cpu = self.cpu
        cpu.pc_stack[0] = TRAP_ADDR
        cpu.pc_sp = 1
        cpu.pc = self.syms[label]
        n = cpu.run(max_steps)
        assert cpu.stopped, f"{label} did not return within {max_steps} steps"
        return n

    # DM struct helpers
    def set_ptr(self, hi_sym, lo_sym, linear):
        self.cpu.dm[SYM[hi_sym]] = (linear >> 16) & 0xFFFF
        self.cpu.dm[SYM[lo_sym]] = linear & 0xFFFF

    def scal(self, sym):
        return self.cpu.dm[SYM[sym]]


def test_bit_reader_matches_refdec():
    rng = np.random.default_rng(7)
    rom = bytes(rng.integers(0, 256, 4096 + 64, dtype=np.uint8))
    h = Harness(rom)
    start = 4090                         # crosses the 4KB bank boundary
    ref = BitReader(PaddedView(rom), start)
    h.set_ptr("B_CHI", "B_CLO", start)
    h.cpu.dm[SYM["B_WHI"]] = h.cpu.dm[SYM["B_WLO"]] = 0
    h.cpu.dm[SYM["B_NB"]] = 0

    ops = []
    for _ in range(120):
        kind = rng.integers(0, 4)
        if kind == 0:
            n = int(rng.integers(1, 10))
            ops.append(("peek", n))
        elif kind == 1:
            n = int(rng.integers(1, 17))
            ops.append(("getu", n))
        elif kind == 2:
            w = int(rng.integers(1, 18))
            ops.append(("gets", w))
        else:
            ops.append(("get1", 1))

    for op, n in ops:
        h.cpu.core.ax0 = n
        h.call(op)
        got = h.cpu.core.ar
        if op == "peek":
            want = ref.peek(n)
            # peek then consume nothing: state must agree too
        elif op == "getu":
            want = ref.get(n)
        elif op == "gets":
            want = ref.get_signed(n) & 0xFFFF
        else:
            want = ref.get(1)
        assert got == want, (op, n, hex(got), hex(want))
    # cursor positions agree
    lin = (h.scal("B_CHI") << 16) | h.scal("B_CLO")
    consumed_bits = (lin - start) * 8 - h.scal("B_NB")
    ref_bits = (ref.pos - start) * 8 - ref.nbits
    assert consumed_bits == ref_bits


def test_transform_matches_refdec():
    from dcsexplorer_tpu.refdec.transform import transform_frame_94x

    rng = np.random.default_rng(3)
    for trial in range(4):
        h = Harness()
        fb = [int(v) for v in rng.integers(0, 0x10000, 512, dtype=np.int64)]
        overlap = [int(v) for v in rng.integers(0, 0x10000, 16, dtype=np.int64)]
        vol_shift = int(rng.integers(0, 9))
        for i, v in enumerate(fb):
            h.cpu.dm[FB + i] = v
        for i, v in enumerate(overlap):
            h.cpu.dm[OVLB + i] = v
        h.cpu.dm[SYM["VSHIFT"]] = vol_shift
        h.cpu.dm[SYM["WPTR"]] = BUF
        h.call("transform")

        ref_fb = list(fb)
        ref_ov = list(overlap)
        out = [0] * 240
        transform_frame_94x(ref_fb, ref_ov, out, vol_shift)
        got_out = [h.cpu.dm[BUF + i] for i in range(240)]
        got_ov = [h.cpu.dm[OVLB + i] for i in range(16)]
        assert got_out == out, f"trial {trial}: PCM mismatch"
        assert got_ov == ref_ov, f"trial {trial}: overlap mismatch"


def _tone_pcm(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    pcm = (6000 * np.sin(2 * np.pi * 440 * t / 31250)
           + 2500 * np.sin(2 * np.pi * 1730 * t / 31250)
           + rng.normal(0, 400, n))
    return pcm.astype(np.float32)


def _fw_stream_setup(h, ch, rom_base, n_frames, loop=1):
    stb = ST + ch * 64
    dm = h.cpu.dm
    hdr = rom_base + 2
    srt = hdr + 16
    dm[stb + S_PLAY] = 1
    dm[stb + S_HDRHI] = (hdr >> 16) & 0xFFFF
    dm[stb + S_HDRLO] = hdr & 0xFFFF
    dm[stb + S_SRTHI] = (srt >> 16) & 0xFFFF
    dm[stb + S_SRTLO] = srt & 0xFFFF
    dm[stb + S_CURHI] = (srt >> 16) & 0xFFFF
    dm[stb + S_CURLO] = srt & 0xFFFF
    dm[stb + S_WHI] = dm[stb + S_WLO] = dm[stb + S_NB] = 0
    dm[stb + S_FCTR] = n_frames
    dm[stb + S_NFRM] = n_frames
    dm[stb + S_LCTR] = loop
    dm[stb + S_NEEDI] = 1


@pytest.mark.parametrize("fmt,sub", [(0, 0), (0, 3), (1, 0), (1, 3)])
def test_decode_frames_match_refdec(fmt, sub):
    from dcsexplorer_tpu.encoder.encoder import CompressionParams, encode_pcm
    from dcsexplorer_tpu.refdec.frames import (StreamState,
                                               decompress_frame_94x)

    params = CompressionParams(stream_format_type=fmt,
                               stream_format_subtype=sub)
    stream, n_frames = encode_pcm(_tone_pcm(seed=fmt * 4 + sub), params)
    rom_base = 0x0F80                    # header crosses the bank boundary
    rom = bytearray(rom_base) + bytearray(stream)
    h = Harness(bytes(rom))
    ch = 2
    mix = 0xE10C
    _fw_stream_setup(h, ch, rom_base, n_frames)
    h.cpu.dm[CH + ch * 64 + C_MMULT] = mix

    st = StreamState()
    mem = PaddedView(bytes(stream))
    st.mem = mem
    st.header_pos = 2
    st.header_len = 16
    st.start_pos = 18
    st.bit = BitReader(mem, 18)
    st.num_frames = n_frames
    st.frame_counter = n_frames
    st.loop_counter = 1

    for frame in range(n_frames):
        if st.bit.pos == st.start_pos and st.bit.nbits == 0:
            st.header = [int(mem[st.header_pos + i]) for i in range(16)]
            st.band_type = [0] * 16
        fb_ref = [0] * 512
        ok = decompress_frame_94x(st, fb_ref, mix)
        assert ok

        for i in range(512):
            h.cpu.dm[FB + i] = 0
        h.cpu.dm[SYM["DCH"]] = ch
        h.call("decode_one")
        got = [h.cpu.dm[FB + i] for i in range(512)]
        assert got == fb_ref, (
            f"frame {frame}: first diff at "
            f"{next(i for i in range(512) if got[i] != fb_ref[i])}")
        assert h.cpu.dm[SYM["ERRF"]] == 0
        # band-type accumulators agree
        bt = [h.cpu.dm[ST + ch * 64 + S_BT + i] for i in range(16)]
        assert bt == st.band_type
    # stream ended: loop counter 1 → playback stops
    assert h.cpu.dm[ST + ch * 64 + S_PLAY] == 0
