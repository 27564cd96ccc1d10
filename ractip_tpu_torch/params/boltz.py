"""Energy tables as torch tensors: what this system has in place of weights.

``tables_to_torch`` carries the JAX package's numpy Boltzmann tables
(ractip_tpu.params.boltz.BoltzTables) onto a device in one dtype;
``sig_tables`` builds the per-instance scaled kernels the DP scans consume
(port of ractip_tpu/ops/scan_pallas.py::_sig_tables).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ractip_tpu.constants import MAXLOOP, PAIR_TYPE, RTYPE
from ractip_tpu.params.boltz import BoltzTables

W = MAXLOOP + 1          # interior-loop window width (31)
POW2 = 11                # doubling steps of the (sigma*ml_base)^d scans


@dataclasses.dataclass(frozen=True)
class TorchTables:
    """BoltzTables fields as tensors (dtype/device fixed at construction)."""

    bt: BoltzTables
    device: torch.device
    dtype: torch.dtype
    pair: torch.Tensor         # [5, 5] long: pair type of (a, b)
    rtype: torch.Tensor        # [8] long: type of the reversed pair
    stack: torch.Tensor
    mismatch_h: torch.Tensor
    mismatch_i: torch.Tensor
    dangle5: torch.Tensor
    dangle3: torch.Tensor
    int11: torch.Tensor
    int21: torch.Tensor
    int22: torch.Tensor
    term_au: torch.Tensor
    tetra: torch.Tensor
    w2_raw: torch.Tensor       # [W, W]
    bulge_raw: torch.Tensor    # [W]

    def hairpin_ext(self, L: int) -> torch.Tensor:
        """Hairpin factors by size 0..L with the lxc extrapolation past 30."""
        bt = self.bt
        sizes = np.arange(max(L + 1, 32), dtype=np.float64)
        hp = np.zeros(max(L + 1, 32))
        hp[:31] = bt.hairpin
        hp[31:] = bt.hairpin[30] * (sizes[31:] / 30.0) ** (
            -10.0 * bt.lxc / bt.kt)
        return torch.as_tensor(hp[:L + 1], dtype=self.dtype,
                               device=self.device)

    def scalar(self, v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=self.dtype, device=self.device)


def tables_to_torch(bt: BoltzTables, device, dtype=torch.float32) -> TorchTables:
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)
    return TorchTables(
        bt=bt, device=dev, dtype=dtype, pair=i(PAIR_TYPE), rtype=i(RTYPE),
        stack=t(bt.stack), mismatch_h=t(bt.mismatch_h),
        mismatch_i=t(bt.mismatch_i), dangle5=t(bt.dangle5),
        dangle3=t(bt.dangle3), int11=t(bt.int11), int21=t(bt.int21),
        int22=t(bt.int22), term_au=t(bt.term_au), tetra=t(bt.tetra),
        w2_raw=t(bt.w2_raw), bulge_raw=t(bt.bulge_raw))


def sig_tables(tt: TorchTables, sig: torch.Tensor):
    """Per-instance (w2k [B, W, W], bulge_k [B, W], pows [B, POW2]).

    w2k[u1, u2] = w2_raw * sig^(u1+u2+2); bulge_k[m] = bulge_raw * sig^(m+2);
    pows[:, s] = (sig * ml_base)^(2^s), the doubling factors of the scans."""
    dt, dev = tt.dtype, tt.device
    sig = sig.to(dt)
    smlb = sig * tt.scalar(tt.bt.ml_base)
    e2 = torch.as_tensor(np.add.outer(np.arange(W), np.arange(W)) + 2,
                         dtype=dt, device=dev)
    w2k = tt.w2_raw[None] * sig[:, None, None] ** e2[None]
    em = torch.arange(MAXLOOP + 1, dtype=dt, device=dev) + 2
    bulge_k = tt.bulge_raw[None] * sig[:, None] ** em[None]
    pw = torch.as_tensor(2.0 ** np.arange(POW2), dtype=dt, device=dev)
    pows = smlb[:, None] ** pw[None]
    return w2k, bulge_k, pows
