"""CLI tools: flag behavior, file lifecycle, pipe mode."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import make_fasta, make_quiva

REPO = Path(__file__).resolve().parent.parent


def run_cli(args, cwd, stdin: bytes | None = None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "-m", "dextractor_tpu", *args],
                          cwd=cwd, input=stdin, capture_output=True, env=env)


def test_dexta_cli_lifecycle(tmp_path):
    rng = np.random.default_rng(0)
    fasta = make_fasta(rng, n_reads=6, max_len=200)
    (tmp_path / "g.fasta").write_bytes(fasta)

    r = run_cli(["dexta", "-v", "g.fasta"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert b"Processing" in r.stderr
    assert not (tmp_path / "g.fasta").exists()      # source removed without -k
    assert (tmp_path / "g.dexta").exists()

    r = run_cli(["undexta", "g.dexta"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert not (tmp_path / "g.dexta").exists()
    assert (tmp_path / "g.fasta").read_bytes() == fasta


def test_verbose_prints_stage_table(tmp_path):
    """-v wires utils/profiling.REPORTER: the per-stage GB/s table is the
    framework's observability layer over the reference's bare per-file
    progress (SURVEY §5; dexta.c:97-100)."""
    rng = np.random.default_rng(5)
    (tmp_path / "g.fasta").write_bytes(make_fasta(rng, n_reads=6,
                                                  max_len=200))
    (tmp_path / "q.quiva").write_bytes(make_quiva(rng, n_reads=4,
                                                  max_len=200))
    r = run_cli(["dexta", "-v", "-k", "g.fasta"], tmp_path)
    assert r.returncode == 0, r.stderr
    for stage in (b"stage", b"GB/s", b"parse", b"encode", b"assemble"):
        assert stage in r.stderr, r.stderr
    r = run_cli(["dexqv", "-v", "-k", "q.quiva"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert b"scan+tables" in r.stderr, r.stderr
    r = run_cli(["undexqv", "-v", "-k", "q.dexqv"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert b"decode" in r.stderr and b"tables" in r.stderr, r.stderr
    # without -v the table stays off (reference-silent batch mode)
    r = run_cli(["undexta", "-k", "g.dexta"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert b"GB/s" not in r.stderr


def test_dexta_pipe_mode(tmp_path):
    rng = np.random.default_rng(1)
    fasta = make_fasta(rng, n_reads=4, max_len=120)
    r = run_cli(["dexta", "-i"], tmp_path, stdin=fasta)
    assert r.returncode == 0, r.stderr
    r2 = run_cli(["undexta", "-i"], tmp_path, stdin=r.stdout)
    assert r2.returncode == 0, r2.stderr
    assert r2.stdout == fasta


def test_undexta_flags(tmp_path):
    rng = np.random.default_rng(2)
    fasta = make_fasta(rng, n_reads=4, max_len=120)
    (tmp_path / "g.fasta").write_bytes(fasta)
    run_cli(["dexta", "-k", "g.fasta"], tmp_path)
    r = run_cli(["undexta", "-k", "-U", "-w60", "g.dexta"], tmp_path)
    assert r.returncode == 0, r.stderr
    out = (tmp_path / "g.fasta").read_bytes()
    assert b"ACGT" in out or b"A" in out.split(b"\n")[1]


def test_dexqv_cli(tmp_path):
    rng = np.random.default_rng(3)
    quiva = make_quiva(rng, n_reads=6, max_len=150)
    (tmp_path / "g.quiva").write_bytes(quiva)
    r = run_cli(["dexqv", "-k", "g.quiva"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = run_cli(["undexqv", "-k", "g.dexqv"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "g.quiva").read_bytes() == quiva


def test_bad_usage(tmp_path):
    r = run_cli(["dexta"], tmp_path)
    assert r.returncode == 1
    assert b"Usage" in r.stderr
    r = run_cli(["undexta", "-z", "x.dexta"], tmp_path)
    assert r.returncode == 1
    r = run_cli(["dexta", "missing.fasta"], tmp_path)
    assert r.returncode == 1
    assert b"Cannot open" in r.stderr


def test_dextract_o_stdout_and_named(tmp_path):
    from conftest import make_bam
    rng = np.random.default_rng(9)
    bam, recs = make_bam(rng, n_reads=5, min_len=600, max_len=800)
    (tmp_path / "m.subreads.bam").write_bytes(bam)

    # bare -o: single stream to stdout
    r = run_cli(["dextract", "-f", "-o", "-eln>=0", "m.subreads.bam"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count(b">") == 5
    # bare -o with two streams is an error
    r = run_cli(["dextract", "-f", "-q", "-o", "-eln>=0", "m.subreads.bam"], tmp_path)
    assert r.returncode == 1
    # -o<name>: named outputs
    r = run_cli(["dextract", "-f", "-q", "-oOUT", "-eln>=0", "m.subreads.bam"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "OUT.fasta").exists()
    assert (tmp_path / "OUT.quiva").exists()


def test_undexqv_upper_flag(tmp_path):
    from conftest import make_quiva
    rng = np.random.default_rng(10)
    quiva = make_quiva(rng, n_reads=4, min_len=10, max_len=80)
    (tmp_path / "g.quiva").write_bytes(quiva)
    r = run_cli(["dexqv", "-k", "g.quiva"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = run_cli(["undexqv", "-k", "-U", "g.dexqv"], tmp_path)
    assert r.returncode == 0, r.stderr
    out = (tmp_path / "g.quiva").read_bytes()
    # delTag lines (2nd of each 5) are uppercased
    lines = out.split(b"\n")
    tag_line = lines[2]
    assert tag_line == tag_line.upper()


def test_dexar_cli_roundtrip(tmp_path):
    # NB: SN headers truncate to snr*100 (dexar.c:159-163) and re-parsing a
    # printed value can truncate again, so header floats may drift by 0.01
    # per cycle exactly as the C tools do.  Byte-identity of the encoded
    # container vs the C encoder is covered by the golden tests; here the
    # CLI contract is: sequences are loss-free and headers keep their shape.
    from conftest import make_arrow
    rng = np.random.default_rng(13)
    arrow = make_arrow(rng, n_reads=5, max_len=200)
    (tmp_path / "g.arrow").write_bytes(arrow)
    assert run_cli(["dexar", "-k", "g.arrow"], tmp_path).returncode == 0
    assert run_cli(["undexar", "-k", "g.dexar"], tmp_path).returncode == 0
    dec1 = (tmp_path / "g.arrow").read_bytes()
    assert [l for l in dec1.split(b"\n") if not l.startswith(b">")] == \
        [l for l in arrow.split(b"\n") if not l.startswith(b">")]
    hdrs = [l for l in dec1.split(b"\n") if l.startswith(b">")]
    assert len(hdrs) == 5 and all(b"SN=" in h for h in hdrs)


def test_dex2db_file_list(tmp_path):
    from conftest import make_bam
    rng = np.random.default_rng(14)
    for i, movie in enumerate((b"m_one", b"m_two")):
        bam, _ = make_bam(rng, n_reads=3, min_len=300, max_len=600, movie=movie)
        (tmp_path / f"in{i}.subreads.bam").write_bytes(bam)
    (tmp_path / "files.txt").write_text("in0.subreads.bam\nin1.subreads.bam\n")
    r = run_cli(["dex2DB", "-ffiles.txt", "-eln>=0", "LISTDB"], tmp_path)
    assert r.returncode == 0, r.stderr
    from dextractor_tpu.db import open_db, read_stub
    stub = read_stub(str(tmp_path / "LISTDB.db"))
    assert stub.nfiles == 2
    assert open_db(str(tmp_path / "LISTDB.db")).nreads == 6


def test_dexar_pipe_mode(tmp_path):
    from conftest import make_arrow
    rng = np.random.default_rng(21)
    arrow = make_arrow(rng, n_reads=3, max_len=90)
    r = run_cli(["dexar", "-i"], tmp_path, stdin=arrow)
    assert r.returncode == 0, r.stderr
    r2 = run_cli(["undexar", "-i"], tmp_path, stdin=r.stdout)
    assert r2.returncode == 0, r2.stderr
    # sequences loss-free through the pipe pair
    assert [l for l in r2.stdout.split(b"\n") if not l.startswith(b">")] == \
        [l for l in arrow.split(b"\n") if not l.startswith(b">")]


# ---------------------------------------------------------------------------
# device-dispatch policy (utils/dispatch): ONE written rule for both codec
# directions and all CLIs — DXT_DEVICE override, else accelerator backend
# ---------------------------------------------------------------------------

def test_device_dispatch_policy(monkeypatch):
    import jax
    from dextractor_tpu.utils import dispatch

    monkeypatch.delenv("DXT_DEVICE", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert dispatch.device_default() is True
    assert dispatch.chain_kernel() == "gpu"     # the Triton chain kernel
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert dispatch.device_default() is False
    assert dispatch.chain_kernel() is None      # the XLA chains
    monkeypatch.setenv("DXT_DEVICE", "1")
    assert dispatch.device_default() is True   # override beats backend
    monkeypatch.setenv("DXT_DEVICE", "0")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert dispatch.device_default() is False
    assert dispatch.chain_kernel() == "gpu"     # DXT_DEVICE picks host vs
    # device only; on the device the backend picks the chain kernel


def test_undexqv_cli_routes_to_device_on_accelerator(monkeypatch, tmp_path):
    """On an accelerator backend the undexqv CLI must take the batched
    device decode, through the GPU chain kernel (its interpret mode here)."""
    import jax
    from dextractor_tpu.codecs import qv_codec
    from dextractor_tpu.cli import undexqv
    from dextractor_tpu.utils import dispatch

    rng = np.random.default_rng(7)
    quiva = make_quiva(rng, n_reads=5, min_len=20, max_len=120)
    enc = qv_codec.encode_quiva_to_dexqv(quiva, device=False)
    f = tmp_path / "g.dexqv"
    f.write_bytes(enc)

    calls = []
    orig = qv_codec._decode_entries_device

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.delenv("DXT_DEVICE", raising=False)
    monkeypatch.setattr(qv_codec, "_decode_entries_device", spy)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(dispatch, "chain_kernel", lambda: "interpret")
    rc = undexqv.main(["-k", str(f)])
    assert rc == 0
    assert calls, "CLI decode did not route to the device path"
    assert (tmp_path / "g.quiva").read_bytes() == quiva
