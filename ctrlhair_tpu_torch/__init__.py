# ctrlhair_tpu_torch: the PyTorch/CUDA port of ctrlhair_tpu, for one NVIDIA
# H100.  Same layout as the JAX package: constants, config, models/, ops/,
# pipeline/, utils/, plus convert.py (flax tree -> state dict) and csrc/
# (the hand-written CUDA kernels).  The entry point is
# ctrlhair_tpu_torch.pipeline.editor.HairEditor.
