"""icp_tpu_torch — the PyTorch/CUDA port of icp_tpu (2D LiDAR SLAM).

Same module layout and function names as ``icp_tpu``; plain functions on
torch tensors that create their outputs on the device of their inputs. The
two Pallas kernels of ``icp_tpu.ops.pallas.nn_kernel`` are hand-written
CUDA kernels for Hopper (``csrc/nn_kernel.cu``, bound in
``ops/hopper/nn_kernel.py``); everything ``icp_tpu`` leaves to XLA is plain
torch here.

Layout:
  ops/       masked tensor ops (NN, dense-grid NN, voxel, eig2x2, rigid
             solves, RANSAC, sweeps, raytrace) + ops/hopper (CUDA
             kernels, their build and bindings)
  models/    ICP (2-D and 3-D brute force, dense-grid icp_large), pre-alignment (rotation search, features/RANSAC),
             occupancy grid (with replay), SE(2) pose graph, fused SLAM step
  parallel/  the device mesh (virtual shards, torch.distributed), sharded
             sweep and grids, distributed pose-graph solves (dense, PCG,
             Schur), the scaled pipeline (BASELINE config #5) over a mesh
  services/  lidar/IMU CSV ingestion (native parser, numpy without a compiler)
  runtime/   ctypes loader of the native CSV parser (csrc/fastcsv.cpp)
  utils/     SE(2) transforms, masking, config, synthetic data, metrics,
             PNG rasteriser, live map window
  engine.py  streaming SLAM engine (fused batched path, modular path, loop
             closure, checkpoints, live-map snapshots)
  cli.py     command-line entry
  demos/     3-D ICP correctness demo (teapot)
  tools/     cloud viewers and players, ATE A/B, profiling, entry(),
             dryrun_multichip()

This package never imports jax.
"""
import torch as _torch

# Geometry needs true f32 products: the counterpart of icp_tpu's
# jax_default_matmul_precision="highest". TF32 keeps ~10 mantissa bits,
# which is millimetres on metre-scale clouds.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
from icp_tpu_torch.utils import se2  # noqa: E402,F401
from icp_tpu_torch.utils.config import SlamConfig, load_config  # noqa: E402,F401
