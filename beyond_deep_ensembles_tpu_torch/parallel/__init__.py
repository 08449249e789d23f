"""Step and eval runners (``multistep.py``); the mesh and data-parallel
pipelines of the JAX package's ``parallel/`` are not ported yet."""
from .multistep import make_epoch_runner, make_eval_runner, make_multi_step, stack_batches  # noqa: F401
