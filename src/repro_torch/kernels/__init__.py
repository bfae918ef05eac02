"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the dispatch between them.  Importing builds nothing: a kernel is compiled
from ``csrc/`` at its first launch."""
from . import (build, dcsim_step, flash_attention, ops, ref, ssm_scan,
               telemetry_bin)
