"""Hand-written Hopper kernels (CUDA C++ in ``repro_torch/csrc``).

Each kernel package holds ``kernel.py`` (the ctypes launch wrapper with its
launch counter), ``ops.py`` (the public function: device dispatch, padding,
merges) and ``ref.py`` (the plain PyTorch version the CPU takes and the card
is checked against).  :mod:`repro_torch.kernels.build` compiles the sources.
"""
