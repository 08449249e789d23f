"""Utilities: checkpoints, config sweeps, devices, early stopping, logging,
optimizers, profiling and schedules.

Not ported, each by design:
  * ``utils/perf.py`` (the TPU's fast hardware RNG switch): K1 and K3 draw
    by Philox in their kernels, and the host's draws are counter hashes
    (``keys.py``);
  * ``utils/compile_cache.py`` and the JAX CLI's ``_enable_cache`` (XLA's
    persistent compilation cache and the TPU RNG switch): nothing on a card
    compiles through XLA; the kernels' builds are cached by
    ``ops/_cuda_build.py`` and Triton.
"""
