"""Mocked multi-host run: 2 CPU processes under jax.distributed.

The reference scales by fanning independent jobs over DB blocks
(Block_Looper, DB.c:2657-2923); this framework's equivalent is one
jax.distributed cluster whose mesh spans all hosts.  This spawns two real
processes, initializes the coordination service, runs the phase-A scan
with its cross-process psum, encodes per-host blocks, and asserts the
ordered concatenation equals the single-process file byte-for-byte.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from conftest import make_quiva

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_encode(tmp_path):
    rng = np.random.default_rng(13)
    quiva = make_quiva(rng, n_reads=15, min_len=100, max_len=400)
    src = tmp_path / "g.quiva"
    src.write_bytes(quiva)

    coordinator = f"127.0.0.1:{_free_port()}"
    worker = os.path.join(ROOT, "tests", "_mp_worker.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("JAX_NUM_CPU_DEVICES", None)   # scrub any inherited value
    procs = [subprocess.Popen(
        [sys.executable, worker, coordinator, str(pid), "2", str(src),
         str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out.decode(), err.decode()[-2000:])

    assembled = (tmp_path / "part0.bin").read_bytes() \
        + (tmp_path / "part1.bin").read_bytes()

    # single-process golden (host path — byte-exact vs the C encoder per
    # the golden tests in test_qv_codec)
    from dextractor_tpu.codecs.qv_codec import encode_quiva_to_dexqv
    golden = encode_quiva_to_dexqv(quiva, device=False)
    assert assembled == golden
