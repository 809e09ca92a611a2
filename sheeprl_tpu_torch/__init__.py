"""PyTorch/CUDA port of sheeprl_tpu for NVIDIA Hopper.

The package keeps the JAX package's layout and module names so each module
has an obvious counterpart in ``sheeprl_tpu/``; it imports nothing of JAX
and nothing of that package. Importing it registers no algorithm: the CLI
(``python -m sheeprl_tpu_torch run ...``) imports the algorithm modules.
"""
