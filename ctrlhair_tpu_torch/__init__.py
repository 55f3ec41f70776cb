# ctrlhair_tpu_torch: the PyTorch/CUDA port of ctrlhair_tpu, for one NVIDIA
# H100.  Same layout as the JAX package: constants, config, models/, ops/,
# pipeline/, utils/, plus convert/ (flax tree -> state dict, and the loader
# of the shipped checkpoints) and csrc/ (the hand-written CUDA kernels).  The
# entry points are ctrlhair_tpu_torch.pipeline.backend.Backend (the session;
# Backend() boots from model_trained/) and, under it,
# ctrlhair_tpu_torch.pipeline.editor.HairEditor.
