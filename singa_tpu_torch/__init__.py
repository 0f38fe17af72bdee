"""singa_tpu_torch — the PyTorch/CUDA port of singa_tpu for NVIDIA Hopper.

The JAX package (``singa_tpu``) is the reference this port is held
against; every module here keeps the name of its counterpart there, so
``singa_tpu_torch.ops.flash_attention`` is the port of
``singa_tpu.ops.flash_attention``.  Plain tensor code is PyTorch; each
Pallas kernel of the reference becomes a kernel written by hand for
Hopper (CUDA C++ under ``csrc/``, built at first use).

This package never imports jax or singa_tpu: what it needs from the
reference is copied and adapted here.

Entry points run on the card unless the caller asks for the CPU:
``device.create_device("auto")`` is the CUDA device and raises when no
card is present; ``create_device("cpu")`` is the explicit host device
the tests use.
"""

__version__ = "0.1.0"

from . import device
from . import proto
from . import tensor
from . import autograd
from . import layer
from . import model
from . import opt
from . import graph
from . import ops
from . import models
from . import utils
from . import obs
from . import faults
from . import serve
from . import sonnx
from . import parallel
from . import autotune
from . import train

__all__ = ["device", "proto", "tensor", "autograd", "layer", "model", "opt", "graph", "ops",
           "models", "utils", "obs", "faults", "serve", "sonnx", "parallel",
           "autotune", "train"]
