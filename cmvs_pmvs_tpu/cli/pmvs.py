"""pmvs3 CLI: dense reconstruction of one cluster
(reference source/pmvs.cpp:7-63). Usage: pmvs3 prefix option_file"""
from __future__ import annotations

import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("Usage: pmvs3 prefix option_file", file=sys.stderr)
        return 1
    prefix, option = argv[0], argv[1]
    from ..models.engine import reconstruct
    from ..utils.cache import enable_compile_cache
    enable_compile_cache()
    reconstruct(prefix, option)
    return 0


if __name__ == "__main__":
    sys.exit(main())
