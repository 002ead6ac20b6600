"""dcsexplorer_tpu — a JAX/XLA framework for the DCS audio format.

A ground-up rebuild of the capabilities of mjrgh/DCSExplorer that decodes and
encodes on an accelerator (an NVIDIA GPU; the CPU backend for tests):

- ``rom``      — host-side ROM model: zip loading, U2..U9 identification, catalog,
                 checksums, HW/OS/game detection (reference: DCSDecoder/DCSDecoder.cpp).
- ``format``   — the DCS format's constant tables (Huffman codebooks, band tables,
                 scale factors, IFFT coefficient tables) as NumPy data.
- ``refdec``   — the bit-exact host scalar reference decoder (NumPy oracle).
- ``ops``      — JAX device kernels: fixed-point 1.15 math, batched bitstream
                 parse, dequant/scale, 256-point integer IFFT, overlap-add, mixer.
- ``models``   — assembled decoder pipelines (single stream, batched catalog sweep).
- ``vm``       — track byte-code VM, command queue / data-port protocol, boot state
                 machine (host side, branchy control flow).
- ``encoder``  — forward path: analysis transform, bit allocation, quantizer search,
                 Huffman pack (batched over files and format candidates).
- ``compiler`` — script-driven ROM compiler (script parser, layout, checksums, zip).
- ``parallel`` — device-mesh sharding for multi-chip catalog sweeps.
- ``tools``    — CLI entry points (explorer, encoder).
- ``native``   — C++ host runtime (fast scalar decode / bitstream pre-scan) via ctypes.
"""

__version__ = "0.1.0"
