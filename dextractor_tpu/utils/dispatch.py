"""Device-dispatch policy — the ONE place that decides host vs device and
which device implementation runs.

``device_default()`` — should a codec entry point (encode_*/decode_*,
and therefore every CLI) run its batched device pipeline or its native
host path when the caller passed ``device=None``?  Policy: the env var
``DXT_DEVICE`` wins ("1" forces the device pipeline, "0" forces the
native host path); otherwise use the device exactly when an accelerator
backend is active.  Both codec directions and all CLIs consult this one
predicate — encode and decode never default differently.

``chain_kernel()`` — which implementation runs the Huffman decode
chains: "gpu" (the Pallas/Triton kernel of ops/chain_gpu) on a GPU
backend, None (the XLA chains of ops/decode2 and ops/decode_jax)
elsewhere.  Tests substitute "interpret" to run the kernel's code path
on the CPU.
"""

from __future__ import annotations

import os


def chain_kernel() -> str | None:
    import jax

    return "gpu" if jax.default_backend() == "gpu" else None


def device_default() -> bool:
    v = os.environ.get("DXT_DEVICE")
    if v:
        return v == "1"
    import jax

    return jax.default_backend() != "cpu"
