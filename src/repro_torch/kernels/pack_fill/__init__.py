"""Eva's fleet-scale packing pass (``repro/core/engine_jax.py``'s jitted
``_pack_all_types``) as one hand-written CUDA kernel, ``csrc/pack_fill.cu``,
beside its plain PyTorch version, ``ref.pack_all_types_ref``."""
