"""Multi-process worker: one simulated host of a 2-process CPU cluster.

Run as: python _mp_worker.py <coordinator> <pid> <nprocs> <quiva> <outdir>

Exercises the full distributed flow: jax.distributed.initialize over a
real coordination service, a global mesh spanning both processes, the
phase-A scan with its cross-process psum reduction, and per-host phase-B
encode of this host's contiguous read block framed exactly as the serial
encoder would (so ordered concatenation reproduces the whole container).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    coordinator, pid, nprocs, quiva_path, outdir = sys.argv[1:6]
    pid, nprocs = int(pid), int(nprocs)

    import jax
    jax.config.update("jax_platforms", "cpu")

    import numpy as np
    from jax.sharding import Mesh
    from dextractor_tpu.parallel import multihost
    from dextractor_tpu.parallel.mesh import DATA_AXIS
    from dextractor_tpu.parallel.pipeline import sharded_scan_to_stats
    from dextractor_tpu.formats.quiva import parse_quiva
    from dextractor_tpu.formats.ragged import pad_rows
    from dextractor_tpu.formats import dexqv as dq
    from dextractor_tpu.codecs.qv_codec import create_qvcoding, encode_entry

    multihost.initialize(coordinator=coordinator, num_processes=nprocs,
                         process_id=pid)
    assert jax.process_count() == nprocs, jax.process_count()

    data = open(quiva_path, "rb").read()
    q = parse_quiva(data)
    lengths = q.lengths.astype(np.int64)
    streams = np.stack([pad_rows(q.streams[s], lengths, align=512)
                        for s in range(5)])

    # global mesh over every device of every process
    mesh = Mesh(np.array(jax.devices()), (DATA_AXIS,))

    # phase A: cross-process psum'd statistics -> identical coding everywhere
    stats = sharded_scan_to_stats(mesh, streams, lengths)
    coding = create_qvcoding(stats, q.prefix, False)

    # phase B: this host encodes its contiguous read block
    beg, end = multihost.process_read_range(q.n_entries, pid, nprocs)
    offs = np.zeros(q.n_entries + 1, np.int64)
    np.cumsum(lengths, out=offs[1:])
    blobs = [encode_entry(coding, *(q.streams[s, offs[i]:offs[i + 1]]
                                    for s in range(5)), False)
             for i in range(beg, end)]
    part = dq.write_dexqv(
        coding, q.wells[beg:end], q.begs[beg:end], q.ends[beg:end],
        q.qvs[beg:end], blobs,
        prev_well=int(q.wells[beg - 1]) if beg > 0 else 0,
        include_header=(pid == 0))
    with open(os.path.join(outdir, f"part{pid}.bin"), "wb") as f:
        f.write(part)
    print(f"worker {pid}: {end - beg} entries, {len(part)} bytes, "
          f"procs={jax.process_count()} devices={len(jax.devices())}")


if __name__ == "__main__":
    main()
