"""Energy tables: numpy Boltzmann factors, and the same as torch tensors.

``get_boltz`` turns EnergyParams into numpy Boltzmann-factor tables
(BoltzTables; a copy of ractip_tpu/params/boltz.py).  ``tables_to_torch``
carries them onto a device in one dtype: they are what this system has in
place of weights.  ``sig_tables`` builds the per-instance scaled kernels the
DP scans consume (port of ractip_tpu/ops/scan_pallas.py::_sig_tables).

Energies (dekacal) become multiplicative factors exp(-E*10/kT); forbidden
(INF) entries become 0.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..constants import GASCONST, INF, K0, MAXLOOP, PAIR_TYPE, RTYPE
from .tables import EnergyParams

W = MAXLOOP + 1          # interior-loop window width (31)
POW2 = 11                # doubling steps of the (sigma*ml_base)^d scans


def _bf(e: np.ndarray | float, kt: float) -> np.ndarray:
    e = np.asarray(e, dtype=np.float64)
    out = np.exp(-e * 10.0 / kt)
    out = np.where(e >= INF / 2, 0.0, out)
    return out


@dataclasses.dataclass(frozen=True)
class BoltzTables:
    stack: np.ndarray        # [8,8]
    mismatch_h: np.ndarray   # [8,5,5]
    mismatch_i: np.ndarray   # [8,5,5]
    dangle5: np.ndarray      # [8,5]  (factor 1.0 where base index 0 = missing)
    dangle3: np.ndarray      # [8,5]
    int11: np.ndarray        # [8,8,5,5]
    int21: np.ndarray        # [8,8,5,5,5]
    int22: np.ndarray        # [8,8,5,5,5,5]
    hairpin: np.ndarray      # [31]
    bulge: np.ndarray        # [31]
    internal: np.ndarray     # [31]
    term_au: np.ndarray      # [8] factor per pair type (1.0 for CG/GC)
    ml_base: float
    ml_closing: float
    ml_intern: float
    duplex_init: float
    lxc: float
    kt: float
    sigma: float             # per-base scale multiplier (<1)
    tetra: np.ndarray        # [5**6] multiplicative bonus factors
    w2: np.ndarray           # [MAXLOOP+1, MAXLOOP+1] generic-interior kernel
                             #   (size + ninio factors; special cells zeroed;
                             #    sigma^(u1+u2+2) folded in)
    bulge_kernel: np.ndarray  # [MAXLOOP+1] bulge factors for m>=2 (sigma^(m+2) folded)
    w2_raw: np.ndarray       # generic-interior kernel without sigma scaling
    bulge_raw: np.ndarray    # bulge m>=2 factors without sigma scaling


def make_boltz(p: EnergyParams) -> BoltzTables:
    kt = (p.temperature + K0) * GASCONST
    # Vienna's default pf scaling heuristic: ~exp(-0.185 kcal / base / kT)
    sigma = math.exp(-185.0 / kt)

    d5 = _bf(p.dangle5, kt)
    d3 = _bf(p.dangle3, kt)
    # base index 0 = missing/unknown neighbor: contribute nothing
    d5[:, 0] = 1.0
    d3[:, 0] = 1.0

    term_au = np.ones(8, dtype=np.float64)
    term_au[3:7] = _bf(p.terminal_au, kt)

    tetra = np.ones(5 ** 6, dtype=np.float64)
    for k, b in zip(p.tetraloop_keys, p.tetraloop_bonus):
        tetra[int(k)] = _bf(float(b), kt)

    w2_raw = np.zeros((MAXLOOP + 1, MAXLOOP + 1), dtype=np.float64)
    sigpow = np.ones_like(w2_raw)
    for u1 in range(1, MAXLOOP):
        for u2 in range(1, MAXLOOP + 1 - u1):
            if (u1, u2) in ((1, 1), (1, 2), (2, 1), (2, 2)):
                continue  # exact int11/int21/int22 terms handle these
            e = float(p.internal[u1 + u2]) + min(p.max_ninio, abs(u1 - u2) * p.ninio_m)
            w2_raw[u1, u2] = float(_bf(e, kt))
            sigpow[u1, u2] = sigma ** (u1 + u2 + 2)
    w2 = w2_raw * sigpow

    bulge_raw = np.zeros(MAXLOOP + 1, dtype=np.float64)
    bulge_kernel = np.zeros(MAXLOOP + 1, dtype=np.float64)
    for m in range(2, MAXLOOP + 1):
        bulge_raw[m] = float(_bf(float(p.bulge[m]), kt))
        bulge_kernel[m] = bulge_raw[m] * sigma ** (m + 2)

    return BoltzTables(
        stack=_bf(p.stack, kt),
        mismatch_h=_bf(p.mismatch_h, kt),
        mismatch_i=_bf(p.mismatch_i, kt),
        dangle5=d5,
        dangle3=d3,
        int11=_bf(p.int11, kt),
        int21=_bf(p.int21, kt),
        int22=_bf(p.int22, kt),
        hairpin=_bf(p.hairpin, kt),
        bulge=_bf(p.bulge, kt),
        internal=_bf(p.internal, kt),
        term_au=term_au,
        ml_base=float(_bf(float(p.ml_base), kt)),
        ml_closing=float(_bf(float(p.ml_closing), kt)),
        ml_intern=float(_bf(float(p.ml_intern), kt)),
        duplex_init=float(_bf(float(p.duplex_init), kt)),
        lxc=p.lxc,
        kt=kt,
        sigma=sigma,
        tetra=tetra,
        w2=w2,
        bulge_kernel=bulge_kernel,
        w2_raw=w2_raw,
        bulge_raw=bulge_raw,
    )


_CACHE: dict[int, tuple[EnergyParams, BoltzTables]] = {}


def get_boltz(p: EnergyParams) -> BoltzTables:
    """The tables of p, cached by identity.  The entry holds p itself, so
    its id cannot pass to another parameter set (say one read by -P) while
    the entry lives."""
    hit = _CACHE.get(id(p))
    if hit is None or hit[0] is not p:
        hit = _CACHE[id(p)] = (p, make_boltz(p))
    return hit[1]


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
    bulge: torch.Tensor        # [W] bulge factors by size (bulge[1]: duplex)
    duplex_init: torch.Tensor  # scalar duplex-initiation factor

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
        w2_raw=t(bt.w2_raw), bulge_raw=t(bt.bulge_raw), bulge=t(bt.bulge),
        duplex_init=t(bt.duplex_init))


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
