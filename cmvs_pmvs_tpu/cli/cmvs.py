"""cmvs3 CLI: view clustering (reference source/cmvs.cpp:7-59).
Usage: cmvs3 prefix [maximage=100] [CPU=4]"""
from __future__ import annotations

import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 1:
        print("Usage: cmvs3 prefix maximage[=100] CPU[=4]",
              file=sys.stderr)
        return 1
    prefix = argv[0]
    maximage = int(argv[1]) if len(argv) >= 2 else 100
    from ..models.cmvs import run_cmvs
    from ..utils.cache import enable_compile_cache
    enable_compile_cache()
    run_cmvs(prefix, maximage=maximage)
    return 0


if __name__ == "__main__":
    sys.exit(main())
