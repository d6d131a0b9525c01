"""repro_torch: GPU BUCKET SORT (Dehne & Zaboli 2010) in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

Entry points sort on CUDA by default and raise without it; pass
``device="cpu"`` to run the kernels' plain PyTorch versions.
"""

from repro_torch.core import *  # noqa: F401,F403
from repro_torch.core import __all__  # noqa: F401
