"""PyTorch/CUDA port of ``beyond_deep_ensembles_tpu``.

The JAX package stays the reference; this package mirrors its module layout
(``methods/api.py`` here is the counterpart of ``methods/api.py`` there) and
imports neither JAX nor the JAX package. Layouts follow PyTorch: NCHW
activations, OIHW conv kernels, ``[out, in]`` dense kernels;
``models/jax_convert.py`` moves flax weights across.

Entry points (``experiments.cifar.build``/``train``/``eval_model``/
``run_single``) run on CUDA unless the caller passes ``device="cpu"``.
Hand-written Hopper kernels live under ``ops/``; on CPU tensors each wrapper
runs its plain PyTorch version instead.
"""
