"""wire_tpu_torch: the PyTorch/CUDA port of wire_tpu for NVIDIA Hopper.

It mirrors wire_tpu's layout (signals/, nn/, ops/, train/, apps/, and
native/ for the host marching cubes) and
imports neither jax nor wire_tpu.  Each Pallas kernel of wire_tpu becomes a
hand-written CUDA kernel under ``csrc/``, built with nvcc at first launch
(``ops/build.py``); its plain PyTorch version runs for CPU tensors.

Importing the package does nothing but define names; pick modules
explicitly, e.g. ``from wire_tpu_torch.nn.registry import get_inr``.
"""
