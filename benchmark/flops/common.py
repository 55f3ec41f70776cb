def conv(n: int, cin: int, cout: int, k: int, out_hw: int) -> int:
    """A k x k convolution producing out_hw pixels a sample."""
    return 2 * n * cin * cout * k * k * out_hw


def dense(n: int, fin: int, fout: int) -> int:
    return 2 * n * fin * fout


def conv_out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1
