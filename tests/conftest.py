"""Test harness configuration.

Tests run on the CPU with 8 virtual XLA devices so the multi-device
sharding path is exercised without accelerators; tests marked ``gpu`` need
a CUDA device and skip without one (``python chip_smoke.py`` runs their
checks on the card).  The reference C tools are compiled once per session
from the reference source tree (``REFERENCE``) when it exists and used
purely as black-box oracles for golden byte-identity tests; without it
those tests skip.
"""

import os
import subprocess
import sys
from pathlib import Path

# Must happen before jax is imported anywhere: the suite runs on the CPU.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE = Path("/root/reference")
TOOLS = ["dexta", "undexta", "dexar", "undexar", "dexqv", "undexqv"]


@pytest.fixture(scope="session")
def ref_tools(tmp_path_factory):
    """Compile the reference codec tools as test oracles; skip if unavailable."""
    if not REFERENCE.is_dir():
        pytest.skip("reference tree not available")
    build = tmp_path_factory.mktemp("refbuild")
    for src in REFERENCE.glob("*.[ch]"):
        (build / src.name).write_bytes(src.read_bytes())
    for tool in TOOLS:
        # -fno-strict-aliasing: the reference's Decode GET macros alias a
        # uint64 window through uint32/uint16/uint8 pointers (QV.c:519-527),
        # which miscompiles under gcc 12 -O2/-O3 strict aliasing.
        r = subprocess.run(
            ["gcc", "-O2", "-fno-strict-aliasing", "-o", tool,
             f"{tool}.c", "DB.c", "QV.c", "-lm"],
            cwd=build, capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"could not build reference {tool}: {r.stderr[:400]}")
    return build


def run_ref(tools_dir, tool, args, cwd):
    r = subprocess.run([str(tools_dir / tool), *args], cwd=cwd,
                       capture_output=True, text=True)
    assert r.returncode == 0, f"{tool} failed: {r.stderr}"
    return r


from dextractor_tpu.testdata import (  # noqa: E402,F401  (re-exported)
    bgzf_compress, make_arrow, make_bam, make_fasta, make_quiva)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"] \
        if jax.default_backend() == "gpu" else []
    if not devs:
        pytest.skip("needs a CUDA device (run python chip_smoke.py on one)")
    return devs[0]
