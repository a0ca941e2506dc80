"""dstagnn_drought_tpu_torch — the PyTorch/CUDA port of dstagnn_drought_tpu.

The JAX package ``dstagnn_drought_tpu`` is the reference; this package mirrors
its module names so each module's counterpart is easy to find, and imports
neither ``jax`` nor anything of the JAX package.

Layers (bottom-up):
  csrc/      CUDA C++ kernels for sm_90a (one per ported Pallas kernel)
  ops/       tensor functions; ops/cuda/ binds and wraps the kernels
  models/    the DSTAGNN ``nn.Module`` (dense branch)
  data/      windowing pipeline, adjacency IO, windowed-dataset loading
  training/  eager train/eval steps, checkpointing, metrics, trainer loop
  cli/       ``python -m dstagnn_drought_tpu_torch.cli.train``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
