"""End-to-end: instrument files -> extraction -> compression -> DB -> decode.

The full reference workflow (README.md:37-43) driven through our CLIs and
library, with C-oracle checks where the reference tools can run.
"""

import os

import numpy as np
import pytest

from conftest import make_bam, run_ref

from dextractor_tpu.cli.dextract import main as dextract_main
from dextractor_tpu.cli.dex2DB import main as dex2db_main
from dextractor_tpu.cli.dexta import main as dexta_main
from dextractor_tpu.cli.dexqv import main as dexqv_main
from dextractor_tpu.db import open_db


def test_full_pipeline(tmp_path, ref_tools):
    rng = np.random.default_rng(99)
    bam, recs = make_bam(rng, n_reads=10, min_len=600, max_len=1200)
    (tmp_path / "m.subreads.bam").write_bytes(bam)

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        # 1. extract all three text forms
        assert dextract_main(["-f", "-q", "-a", "-eln>=0",
                              "m.subreads.bam"]) == 0
        fasta = (tmp_path / "m.fasta").read_bytes()
        quiva = (tmp_path / "m.quiva").read_bytes()

        # 2. compress with our tools; byte-identity vs the C encoders
        assert dexta_main(["-k", "m.fasta"]) == 0
        assert dexqv_main(["-k", "m.quiva"]) == 0
        ours_dexta = (tmp_path / "m.dexta").read_bytes()
        ours_dexqv = (tmp_path / "m.dexqv").read_bytes()
        (tmp_path / "c.fasta").write_bytes(fasta)
        (tmp_path / "c.quiva").write_bytes(quiva)
        run_ref(ref_tools, "dexta", ["-k", "c.fasta"], tmp_path)
        run_ref(ref_tools, "dexqv", ["-k", "c.quiva"], tmp_path)
        assert ours_dexta == (tmp_path / "c.dexta").read_bytes()
        assert ours_dexqv == (tmp_path / "c.dexqv").read_bytes()

        # 3. compression north star: ratio ~4x for bases
        n_bases = sum(e["ln"] for e in recs)
        assert len(ours_dexta) < n_bases / 3.5

        # 4. build a quiver DB straight from the instrument file
        assert dex2db_main(["-q", "-eln>=0", "FULL", "m.subreads.bam"]) == 0
        db = open_db("FULL.db")
        assert db.nreads == 10
        db.open_qvs()

        # 5. batched device decode equals the instrument data
        streams, lengths = db.load_all_qventries(ascii_mode=1)
        off = np.zeros(db.nreads + 1, np.int64)
        np.cumsum(lengths, out=off[1:])
        for i, e in enumerate(recs):
            np.testing.assert_array_equal(
                streams[0, off[i]: off[i + 1]],
                np.frombuffer(e["qvs"][0], np.uint8))
            assert db.load_read(i, ascii_mode=2) == e["seq"]
    finally:
        os.chdir(cwd)
