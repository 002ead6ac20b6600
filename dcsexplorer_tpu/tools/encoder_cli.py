"""dcsencoder — DCS stream/ROM encoder CLI.

Counterpart of the reference's DCSEncoder program (reference:
DCSEncoder/Main.cpp): transcode audio files into DCS streams (raw 'DCSa'
containers) or compile a script into a full ROM zip.

Usage:
  python -m dcsexplorer_tpu.tools.encoder_cli input.wav -o out.dcs [options]
  python -m dcsexplorer_tpu.tools.encoder_cli --script build.dcss -o roms.zip
"""

import argparse
import os
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="dcsencoder",
        description="DCS audio encoder / ROM compiler")
    from .. import __version__
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("inputs", nargs="*", help="WAV or raw .dcs input files")
    p.add_argument("-o", "--output", help="output file (.dcs) or directory")
    p.add_argument("--script", help="compile a DCS script into a ROM zip")
    p.add_argument("--patch", metavar="PROTO.zip",
                   help="patch mode: import this prototype ROM, apply the "
                        "script's changes, regenerate")
    p.add_argument("--bitrate", type=int, default=128000,
                   help="target bit rate (bits/s)")
    p.add_argument("--cutoff", type=float, default=0.97,
                   help="power band cutoff fraction (1.0 keeps all bands)")
    p.add_argument("--max-error", type=float, default=10.0 / 32768.0,
                   help="max quantization error (fraction of full scale)")
    p.add_argument("--format-type", type=int, default=-1, choices=(-1, 0, 1),
                   help="stream format major type (-1 = try both, keep "
                        "smallest)")
    p.add_argument("--format-subtype", type=int, default=-1,
                   choices=(-1, 0, 3),
                   help="stream format subtype (-1 = try both)")
    p.add_argument("--format-version", default="94",
                   choices=("93a", "93b", "94", "95"),
                   help="codec family for raw stream output (reference "
                        "formatVersion 0x9301/0x9300/0x9400)")
    p.add_argument("--rom-size", default=None, choices=("512K", "1M"),
                   help="per-chip ROM size for --script output (default: "
                        "the script/prototype's size, 512K)")
    p.add_argument("--rom-prefix", default="sound_",
                   help="zip entry name prefix for generated ROM images")
    p.add_argument("--stream-dir", default=None,
                   help="directory searched for stream files named in the "
                        "script (default: the script's directory)")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress the layout report")
    p.add_argument("--check", action="store_true",
                   help="round-trip decode each stream and report SNR")
    return p


def _load_audio(path):
    from ..utils import audioio
    if audioio.is_dcs_raw(path):
        stream, osv = audioio.read_dcs_raw(path)
        return ("dcs", stream, osv)
    audio, rate = audioio.read_audio(path)
    return ("pcm", audio * 32768.0, rate)


def encode_file(path, out_path, params, check=False, os_version=None):
    from ..encoder import encoder as enc
    from ..utils import audioio
    from ..refdec.decoder import OS94

    if os_version is None:
        os_version = OS94
    kind, data, meta = _load_audio(path)
    if kind == "dcs":
        if meta == os_version:
            # already a DCS stream of the target family: pass through
            audioio.write_dcs_raw(out_path, data, meta)
            print(f"{path}: raw DCS stream passed through -> {out_path}")
            return
        # version mismatch: decode + re-encode at the target version
        # (reference DCSEncoder.cpp:358-589 EncodeDCSFile)
        stream, nf = enc.transcode_stream(data, meta, os_version, params)
        audioio.write_dcs_raw(out_path, stream, os_version)
        print(f"{path}: re-encoded (format version {meta} -> {os_version}) "
              f"-> {out_path} ({len(stream)} bytes)")
        return

    stream, nf = enc.encode_pcm(data.astype(np.float32), params,
                                sample_rate=int(meta), os_version=os_version)
    audioio.write_dcs_raw(out_path, stream, os_version)
    secs = nf * 240 / 31250.0
    kbps = len(stream) * 8 / secs / 1000.0
    msg = (f"{path}: {secs:.2f}s -> {out_path} "
           f"({len(stream)} bytes, {kbps:.1f} kbps)")
    if check:
        from ..refdec.decoder import ReferenceDecoder
        dec = ReferenceDecoder()
        dec.default_volume = 255
        dec.init_standalone(os_version)
        dec.soft_boot()
        dec.load_audio_stream(0, stream, mixing_level=0x64)
        out = np.array(dec.next_samples(nf * 240), dtype=np.float64)
        cmp_data = np.asarray(data, dtype=np.float64)
        if int(meta) != 31250:
            from ..encoder.resample import resample
            cmp_data = resample(cmp_data, int(meta), 31250)
        src = np.zeros(nf * 240)
        n = min(src.size, cmp_data.size)
        src[:n] = cmp_data[:n]
        # align for the resampler's group delay (inputs not at 31250 Hz)
        w = min(8192, n)
        lags = np.correlate(out[:w], src[:w], "full")
        lag = int(np.argmax(np.abs(lags))) - (w - 1)
        if lag > 0:
            out_a, src_a = out[lag:], src[:src.size - lag]
        else:
            out_a, src_a = out[:out.size + lag], src[-lag:]
        g = np.dot(out_a, src_a) / max(np.dot(src_a, src_a), 1e-9)
        err = out_a - g * src_a
        snr = 10 * np.log10(max(np.sum((g * src_a) ** 2), 1e-9)
                            / max(np.sum(err ** 2), 1e-9))
        msg += f"  [round-trip SNR {snr:.1f} dB]"
    print(msg)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..encoder.encoder import CompressionParams
    params = CompressionParams(
        stream_format_type=args.format_type,
        stream_format_subtype=args.format_subtype,
        target_bit_rate=args.bitrate,
        power_band_cutoff=args.cutoff,
        maximum_quantization_error=args.max_error)

    if args.script:
        from ..compiler import script as cscript
        out = args.output or "romset.zip"
        try:
            zip_bytes, report = cscript.compile_script_file(
                args.script, params, prototype_zip=args.patch,
                stream_dir=args.stream_dir,
                chip_size={None: None, "512K": 512 * 1024,
                           "1M": 1024 * 1024}[args.rom_size],
                rom_prefix=args.rom_prefix)
        except cscript.ScriptError as e:
            print(f"script error: {e}", file=sys.stderr)
            return 1
        with open(out, "wb") as f:
            f.write(zip_bytes)
        if not args.quiet:
            print(report)
        print(f"ROM set -> {out}")
        return 0

    if not args.inputs:
        print("error: no input files (or use --script)", file=sys.stderr)
        return 2
    for path in args.inputs:
        if not os.path.exists(path):
            print(f"error: not found: {path}", file=sys.stderr)
            return 2
        if args.output and len(args.inputs) == 1 and not os.path.isdir(args.output):
            out_path = args.output
        else:
            base = os.path.splitext(os.path.basename(path))[0] + ".dcs"
            out_path = os.path.join(args.output or ".", base)
        osmap = {"93a": 1, "93b": 2, "94": 3, "95": 4}
        try:
            encode_file(path, out_path, params, check=args.check,
                        os_version=osmap[args.format_version])
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
