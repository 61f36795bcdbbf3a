"""sheeprl_tpu_torch: the PyTorch + CUDA port of ``sheeprl_tpu``.

The package mirrors ``sheeprl_tpu``'s module paths so each module's
counterpart is easy to find.  It imports ``torch`` and never ``jax`` or any
module of ``sheeprl_tpu``: what it needs of the JAX package's host code is
kept here as its own copy.  Importing the package imports nothing else; the
entry point is ``python -m sheeprl_tpu_torch serve checkpoint_path=...``.
"""

__version__ = "0.1.0"
