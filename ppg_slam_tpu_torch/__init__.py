"""ppg_slam_tpu_torch — the PPG-SLAM framework in PyTorch, for CUDA (Hopper).

A port of `ppg_slam_tpu` (the JAX reference) that keeps its module layout and
names, so every module here has a counterpart of the same path there. It
imports `torch` and never `jax` or `ppg_slam_tpu`.

Package layout:
  geometry/   camera models (pinhole + radtan, Kannala-Brandt-8), SO(3),
              SE(3), two-view initialization
  models/     the PPG CNNs as one NCHW `nn.Module`, the TorchScript converter
  ops/        device ops: NMS, heat refine/remap, pair probing, line
              validation, descriptor sampling, gated matching
  kernels/    hand-written CUDA kernels, built with nvcc at first use
  frontend/   the PPG extractor (device decode + native host graph finish)
  native/     C++ host graph finish, loaded with ctypes
  imu/        IMU preintegration
  estimator/  pose and pose-inertial optimization, bundle adjustment,
              inertial initialization
  worldmap/   the host map (keyframes, map points, PPG edges and colines)
  bow/        the DBoW3 vocabulary and its training
  matching/   the host matcher, the device gated-match service, PnP, the
              Sim3 RANSAC
  pipeline/   System, Tracking, LocalMapping, LoopClosing, settings
  datasets/   EuRoC / TUM-VI / UMA loaders, a PNG codec and CLAHE (numpy;
              no OpenCV)
  viz/        the headless viewer (numpy rasterizer)
  cli/        mono_inertial, evaluate, train_vocabulary, profile_frontend
  parallel/   the single-controller device Mesh and the sharded BA
              solver (extract_batch(mesh=) is the front-end's)
  utils/      profiling, trajectory evaluation
  testing.py  fixtures shared by the tests and chip_smoke.py

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

import torch as _torch

__version__ = "0.1.0"

# Numerics policy (the reference pins jax_default_matmul_precision to
# "float32"): f32 contractions are true f32. PyTorch leaves matmul TF32 off
# by default but turns it ON for cuDNN convolutions, which would put every f32
# conv of the PPG net through TF32 (~3 significant digits). bf16 is used only
# where it is chosen explicitly: PPGExtractor(compute_dtype="bf16") and the
# bf16 descriptor distances of ops/device_match.py.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
