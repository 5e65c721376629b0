"""Command-line tools mirroring the reference suite.

Each tool is runnable as ``python -m dextractor_tpu.cli.<tool>`` and via the
``dextractor_tpu.cli.main`` dispatcher.  Flags, usage strings, defaults and
the delete-source-on-success behavior match the reference CLIs.
"""

from __future__ import annotations

import sys

TOOLS = ("dexta", "undexta", "dexar", "undexar", "dexqv", "undexqv",
         "dextract", "dex2DB")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in TOOLS:
        sys.stderr.write(f"usage: dextractor_tpu <tool> [args]\n  tools: {', '.join(TOOLS)}\n")
        return 1
    import importlib
    from ._common import use_compile_cache

    use_compile_cache()
    mod = importlib.import_module(f".{argv[0]}", __package__)
    return mod.main(argv[1:])
