"""Small end-to-end reconstruction on the default JAX backend: a 5-view
plane scene through `reconstruct`. Prints a PASS/FAIL line with the
checks. Run: python scripts/verify_e2e.py"""
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from cmvs_pmvs_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    from cmvs_pmvs_tpu.utils.synthetic import (make_plane_scene,
                                               write_pmvs_tree)
    from cmvs_pmvs_tpu.models.engine import reconstruct

    root = tempfile.mkdtemp(prefix="verify_e2e_")
    scene = make_plane_scene(num_cameras=5, width=256, height=192,
                             focal=400.0)
    write_pmvs_tree(scene, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\n"
                "minImageNum 3\nCPU 4\nsetEdge 0\nuseBound 0\n"
                "useVisData 0\nsequence -1\ntimages -1 0 5\noimages 0\n")
    eng = reconstruct(root, "option.txt", p_cap=30000,
                      expand_iters=1, max_waves=2, refine_iters=8)
    n = int(np.asarray(eng.cloud.alive).sum())
    coord = np.asarray(eng.cloud.coord)[np.asarray(eng.cloud.alive)]
    dscale = np.asarray(eng.cloud.dscale)[np.asarray(eng.cloud.alive)]
    med = float(np.median(scene.plane_distance(coord[:, :3]) / dscale))
    models = os.listdir(os.path.join(root, "models"))
    ok = n > 500 and med < 0.3 and any(m.endswith(".patch") for m in models) \
        and any(m.endswith(".ply") for m in models)
    print(json.dumps({"verify": "PASS" if ok else "FAIL", "patches": n,
                      "median_offset": round(med, 4), "models": models}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
