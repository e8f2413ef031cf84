"""PyTorch + CUDA port of wildgs_slam_tpu for NVIDIA Hopper GPUs.

The port mirrors the JAX package's layout module for module (``ops/``,
``ops/rasterizer/``, ``slam/``, ``models/``, ``utils/``) and is held
against it by the ``tests/test_torch_*.py`` parity tests. It imports torch,
numpy and yaml only. Every entry point takes an explicit ``device`` and
defaults to ``"cuda"``; the CPU is used only when the caller asks for it.

The rasterizer's two composite kernels are hand-written CUDA C++ in
``csrc/`` (built with nvcc at first use, see
``ops/rasterizer/composite_cuda.py``).
"""
