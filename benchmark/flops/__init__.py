# Operations and bytes of the benchmark's work, counted from shapes: the
# products of convolutions, dense layers and contractions, 2 operations a
# multiply-add, as torch.utils.flop_counter counts them.
