"""PyTorch + CUDA port of ``distributed_tensorflow_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package holds the
same contracts in PyTorch and replaces every Pallas kernel on a ported
path with a kernel written by hand for ``sm_90a``. Ported so far: the
paged-KV serving path (``serve.ServeEngine`` over the causal pre-LN
decoder of ``models.transformer``) with its two kernels,
``ops.paged_attention`` and ``ops.fused_ln_matmul``; one-device training
(``workloads.run_workload``) of ``gpt_lm`` with the flash attention
kernels (``ops.flash_attention``) and of ``resnet50_imagenet`` with the
fused 1x1 conv + BatchNorm kernels (``ops.fused_conv_bn``).

Import rules: nothing here imports jax or the JAX package, and importing
this package builds nothing — a kernel is compiled with ``nvcc`` the
first time a wrapper launches it on a CUDA tensor (``ops/_build.py``),
so the package imports on a machine with no ``nvcc`` and no GPU.
"""
