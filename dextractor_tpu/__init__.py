"""dextractor_tpu — a GPU-accelerated lossless codec framework for PacBio
sequencing data.

A ground-up re-design of the capabilities of thegenemyers/DEXTRACTOR as a
JAX program for an NVIDIA GPU:

- ``ops``      JAX/XLA device code: 2-bit pack/unpack, 256-bin histograms,
               Huffman bitstream encode (prefix-sum + scatter) and decode
               (one-lane-per-chain Pallas/Triton kernel), run-length scans.
- ``codecs``   Codec orchestration: .dexta / .dexar (2-bit) and .dexqv
               (per-file adaptive Huffman x6 schemes + RLE + escapes).
- ``formats``  Byte-exact container readers/writers and vectorized text
               parsers (.fasta/.arrow/.quiva) — the host control plane.
- ``parallel`` Mesh/data-parallel read sharding, psum histogram reduction,
               Huffman-table broadcast, ordered variable-length gather.
- ``db``       Dazzler database family (.db stub, .idx/.bps/.qvs/.arw,
               tracks) with transactional append.
- ``ingest``   Instrument-file readers (HDF5 .bax.h5, SAM/BAM) and the
               subread filter expression DSL.
- ``cli``      The eight command-line tools (dextract, dexta/undexta,
               dexar/undexar, dexqv/undexqv, dex2DB).

All compressed outputs are bit-compatible with the reference C tools; all
decoders accept files produced by them (including legacy variants).
"""

__version__ = "0.1.0"
