"""cmvs_pmvs_tpu: GPU multi-view stereo in JAX.

A from-scratch reimplementation of the CMVS/PMVS2 pipeline (Furukawa & Ponce)
as a JAX/XLA framework for NVIDIA GPUs: batched patch-based dense
reconstruction with Gauss-Newton photo-consistency refinement, vectorized
expand/filter waves over per-image cell grids, and CMVS view clustering with
clusters spread over processes or `jax.sharding` meshes.

Layer map (mirrors reference /root/reference layering, SURVEY.md section 1):
  utils/   - options/config (reference include/pmvs/option.hpp)
  io/      - all on-disk formats (cameras, option files, bundler, vis/ske,
             patch/pset/ply, images)
  geom/    - batched cameras, epipolar geometry, triangulation
             (reference include/image/camera.hpp)
  image/   - image pyramids + subpixel sampling (reference include/image/image.hpp)
  ops/     - compute kernels: NCC, Gauss-Newton refine, Harris/DoG detection,
             cell-grid scatter ops (reference source/pmvs/{optim,harris,dog}.cpp)
  models/  - the pipelines: PMVS patch engine, CMVS clustering
             (reference source/pmvs/findMatch.cpp, source/cmvs/bundle.cpp)
  parallel/- device meshes, sharded wave execution, collectives
  cli/     - pmvs3 / cmvs3 / genOption entry points
"""

__version__ = "0.1.0"
