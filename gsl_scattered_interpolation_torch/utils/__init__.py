"""Errors, machine constants, rng, fixtures, integrity checks, serialize,
config, profiling and testing: the modules the JAX package's
``utils/__init__.py`` imports, so ``gsi.utils.<module>`` resolves in both
packages."""

from . import (  # noqa: F401
    config,
    datasets,
    errors,
    integrity,
    machine,
    profiling,
    rng,
    serialize,
    testing,
)
