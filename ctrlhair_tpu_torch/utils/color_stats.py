# Empirical-CDF <-> Gaussian mapping for the HSV colour sliders.
#
# Port of ctrlhair_tpu/utils/color_stats.py.  The reference bisects a sorted
# per-dimension HSV table with scipy on the host per slider move
# (ref: util/color_from_hsv_to_gaussian.py:16-33).  Here the table is one
# tensor on the session's device and both directions are a
# torch.searchsorted / gather, batched over edits.

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def _default_table(n: int = 4096) -> np.ndarray:
    """Fallback HSV statistics table when no dataset table is available.

    Column-wise sorted quantile tables for (H, S, V): a broad smooth prior
    over observed hair colours; replace with the dataset-derived table
    (hsv_stat_dict_ordered.pkl analogue) for exact reference behaviour.
    """
    q = (np.arange(n) + 0.5) / n
    # Hair hues cluster in the red-orange band with a long tail; saturation
    # and value roughly beta-distributed.
    h = 179.0 * q ** 2.2 * 0.35
    s = 255.0 * q ** 0.9
    v = 255.0 * (0.05 + 0.9 * q)
    return np.stack([h, s, v], axis=1).astype(np.float32)


class DistTranslation:
    """gaussian latent <-> raw HSV value translation."""

    def __init__(self, table: np.ndarray | None = None,
                 table_path: str | None = None, device='cpu'):
        if table is None and table_path and os.path.exists(table_path):
            # the table ships with the trained weights of this checkout
            with open(table_path, 'rb') as f:
                table = pickle.load(f)
        if table is None:
            table = _default_table()
        # ensure each column is sorted (column-wise quantile table)
        self.table = torch.tensor(
            np.sort(np.asarray(table, np.float32), axis=0), device=device)
        # [3, n]: searchsorted wants the sorted axis last and contiguous
        self._cols = self.table.t().contiguous()
        self.n = self.table.shape[0]

    def _value(self, val) -> torch.Tensor:
        return torch.as_tensor(val, dtype=torch.float32,
                               device=self.table.device)

    def gaussian_to_val(self, dim: int, val) -> torch.Tensor:
        """Φ(val)-quantile lookup (ref: color_from_hsv_to_gaussian.py:22-25)."""
        cdf = torch.special.ndtr(self._value(val))
        idx = torch.clamp((cdf * self.n).to(torch.int32), 0, self.n - 1)
        return self.table[idx.long(), dim]

    def val_to_gaussian(self, dim: int, val) -> torch.Tensor:
        """Inverse: mid-rank -> Φ⁻¹ (ref: color_from_hsv_to_gaussian.py:27-33)."""
        col = self._cols[dim]
        val = self._value(val)
        left = torch.searchsorted(col, val, side='left')
        right = torch.searchsorted(col, val, side='right')
        p = (left + right).to(torch.float32) / (2.0 * self.n)
        p = torch.clamp(p, 1e-6, 1.0 - 1e-6)
        return torch.special.ndtri(p)
