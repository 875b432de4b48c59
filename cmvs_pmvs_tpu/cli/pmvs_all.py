"""pmvs3_all CLI: run every cluster of a CMVS+genOption tree and merge.

Replaces `sh pmvs.sh` (reference genOption.cpp:58-74 emits one pmvs2
process per cluster). Usage:
    pmvs3_all prefix [process_index process_count] [--no-merge]
With no index/count arguments the JAX process topology is used, so the
same command line works on every host of a multi-host run.
"""
from __future__ import annotations

import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    args = [a for a in argv if not a.startswith("--")]
    merge = "--no-merge" not in argv
    if len(args) < 1:
        print("Usage: pmvs3_all prefix [process_index process_count] "
              "[--no-merge]", file=sys.stderr)
        return 1
    prefix = args[0]
    pidx = int(args[1]) if len(args) > 1 else None
    pcnt = int(args[2]) if len(args) > 2 else None

    from ..parallel.clusters import merge_models, run_clusters
    from ..utils.cache import enable_compile_cache
    enable_compile_cache()
    runs = run_clusters(prefix, process_index=pidx, process_count=pcnt,
                        checkpoint=True)
    total = sum(r.patches for r in runs)
    print(f"{len(runs)} clusters, {total} patches")
    if merge and (pidx in (None, 0)):
        out = merge_models(prefix)
        print(f"merged -> {out}.(patch|pset|ply)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
