"""Environment configuration knobs.

The reference's env surface (SURVEY.md §5): ``GSL_RNG_SEED`` /
``GSL_RNG_TYPE`` (rng/default.c:31-104), ``GSL_IEEE_MODE``
(ieee-utils/env.c:26-28), ``GSL_TEST_VERBOSE`` (test/results.c:42-58).
The port reads the JAX package's names, so one environment drives both:

  GSI_TPU_SEED     default insertion-shuffle / subsample seed (int).
  GSI_TPU_VERBOSE  "1" turns on info logging.

The JAX package's ``GSI_TPU_X64`` and ``enable_compile_cache`` have no
counterpart: the port's precision is each entry point's ``dtype=``
(``device_dtype``: float32 on CUDA, float64 on the CPU), and PyTorch
compiles nothing ahead of time.
"""

from __future__ import annotations

import logging
import os

import torch

log = logging.getLogger("gsl_scattered_interpolation_torch")


def env_seed(default: int | None = None):
    """Seed from GSI_TPU_SEED, like gsl_rng_env_setup (rng/default.c:31)."""
    v = os.environ.get("GSI_TPU_SEED")
    if v is None:
        return default
    return int(v)


def env_setup() -> None:
    """Apply the environment's configuration (call once, at start-up)."""
    if os.environ.get("GSI_TPU_VERBOSE") == "1":
        logging.basicConfig(level=logging.INFO)
        log.setLevel(logging.INFO)


def device_dtype(device, dtype=None):
    """(torch.device, dtype) of an entry point: float32 on CUDA and float64
    elsewhere unless ``dtype`` is given."""
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    return device, dtype
