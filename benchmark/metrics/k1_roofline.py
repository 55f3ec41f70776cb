"""Kernel K1 (csrc/masked_cg.cu): the least time its solve could take on
the card, the larger of its operations at the float32 peak and its bytes
at the HBM rate (benchmark/flops/edit.cg_work), over the mean time of its
launches in the trace, in %."""

from benchmark import peaks
from benchmark.flops.edit import cg_work


def read(trace):
    launches = [o for o in trace.kernels() if 'masked_cg' in o.name]
    shape = trace.counts.get('cg_shape')
    if not launches or shape is None:
        return None
    mean_s = sum(o.end_ns - o.start_ns for o in launches) / len(launches) \
        / 1e9
    ops, nbytes = cg_work(*shape)
    bound_s = max(ops / peaks.FLOPS['float32'],
                  nbytes / peaks.HBM_BYTES_PER_S)
    return 100.0 * bound_s / mean_s
