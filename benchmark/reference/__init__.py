# The plain float32 reference that decides `correct`: straightforward
# PyTorch over the harness's state dicts, no kernel, cache or batching of
# the program.  It imports nothing of ctrlhair_tpu_torch.
