"""The single-pair exact path: posteriors on the GPU, the MILP on the host.

Port of ractip_tpu/pipeline/ractip.py (Prediction :62, Posteriors :75,
_chosen_regions :191, solve_pair :197, solve_ss :261, predict :292; its
_decode :170 is batched.decode_brackets), the reference's run(), solve()
and solve_ss() (reference src/ractip.cpp:1561-1674, :516-1353,
:1366-1465).  The posteriors of one
pair come from the port's batched DPs at B = 1 on `device`:

  bpp  -- scan.batch_fold (K1, K2, K3), each strand under its -c mask
  hp   -- cofold.batch_cofold (K4, K5, K3) under the concatenation's -c
          mask; duplex.batch_duplex (K6) with use_pf_duplex, which ignores
          the constraints as the reference does (src/ractip.cpp:390-399)
  pu   -- accessibility.unpaired_probs on an UNCONSTRAINED fold of each
          strand (the reference's pf_unstru takes no constraint string,
          src/ractip.cpp:369-375): a strand without a mask reuses its fold

and go back to the host as numpy arrays, where solver/candidates.py builds
the joint program and solver/milp.py::exact_solve solves it exactly: with
HiGHS, or under RACTIP_TPU_EXACT_BACKEND=bnb with the branch-and-bound
(solver/bnb.py), whose node LPs run on `device`.

Under the CONTRAfold model (use_contrafold, use_contraduplex; the JAX
package's branch at ractip_tpu/pipeline/ractip.py:88-122, the reference's
contrafold() / contraduplex(), src/ractip.cpp:195-246) bpp comes from the
learned CRF of each strand (ops/contrafold.py, float64) and -c masks do not
apply; hp comes from the cofold (K4, K5, K3), as the reference's
hybridization does even under --contrafold (its contraduplex() call is
commented out, src/ractip.cpp:539-541), from the duplex sweep (K6) with
use_pf_duplex, and from the CRF duplex engine (ops/contraduplex.py) with
use_contraduplex; pu is the width-1 proxy max(0, 1 - sum_j bp(i, j))
(src/ractip.cpp:213-222) in column 1 of an [L, max(1, max_w) + 1] array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve
from ..io.fasta import Fasta
from ..ops import constraints, eos
from ..ops.accessibility import unpaired_probs
from ..ops.cofold import batch_cofold
from ..ops.contraduplex import cd_hybrid_probs
from ..ops.contrafold import cf_base_pair_probs, cf_unpaired_probs
from ..ops.duplex import batch_duplex
from ..ops.scan import as_tables, batch_fold
from ..ops.seq import bucket_length, encode
from ..params.tables import EnergyParams, get_default_params
from ..solver.candidates import JointProblem, SolverConfig, build_problem
from ..solver.milp import exact_solve
from .batched import decode_brackets
from .options import Options
from .shuffle import dinuc_shuffle

@dataclasses.dataclass
class Prediction:
    r1: str
    r2: str
    objective: float
    e1: float | None = None         # free energy, structure 1
    e2: float | None = None
    e3: float | None = None         # hybridization free energy
    e1s: float | None = None        # independent secondary-structure energies
    e2s: float | None = None
    zscore: tuple[float, float] | None = None


def _host(t: torch.Tensor) -> np.ndarray:
    return t[0].detach().cpu().numpy()


class Posteriors:
    """The three probability matrices of one sequence pair, as numpy."""

    def __init__(self, params: EnergyParams, s1: str, s2: str,
                 max_w: int, need_acc: bool, use_pf_duplex: bool = False,
                 cstr1: str | None = None, cstr2: str | None = None,
                 use_contrafold: bool = False,
                 use_contraduplex: bool = False, device="cuda"):
        dev = resolve(device)
        tt = as_tables(params, dev)
        self.n1, self.n2 = len(s1), len(s2)
        self.L1, self.L2 = bucket_length(self.n1), bucket_length(self.n2)
        codes = lambda s, L: torch.as_tensor(encode(s, L)[None],
                                             device=dev).long()
        S1, S2 = codes(s1, self.L1), codes(s2, self.L2)
        n1 = torch.tensor([self.n1], device=dev)
        n2 = torch.tensor([self.n2], device=dev)
        if use_contrafold or use_contraduplex:
            self._contrafold(tt, S1, S2, n1, n2, max_w, need_acc,
                             use_pf_duplex, use_contraduplex, dev)
            return
        # -c/--use-constraint: pf-level hard-constraint masks from the FASTA
        # constraint strings (reference src/ractip.cpp:270-290, :403-444)
        mask = lambda a: None if a is None else torch.as_tensor(
            a[None], device=dev)
        al1 = mask(constraints.fold_allow(cstr1, self.n1, self.L1))
        al2 = mask(constraints.fold_allow(cstr2, self.n2, self.L2))
        alc = mask(constraints.cofold_allow(cstr1, cstr2, self.n1, self.n2,
                                            self.L1 + self.L2))
        f1 = batch_fold(tt, S1, n1, dev, allow=al1)
        f2 = batch_fold(tt, S2, n2, dev, allow=al2)
        self.bpp1, self.bpp2 = _host(f1["bpp"]), _host(f2["bpp"])
        if use_pf_duplex:
            self.hp = _host(batch_duplex(tt, S1, S2, n1, n2).pr)
        else:
            self.hp = _host(batch_cofold(tt, S1, S2, n1, n2, dev,
                                         allow=alc)["hp"])
        self.pu1 = self.pu2 = None
        if need_acc:
            w = max(1, max_w)

            def pu(f, S, n, al):
                if al is not None:      # accessibility runs unconstrained
                    f = batch_fold(tt, S, n, dev)
                return _host(unpaired_probs(tt, f["ff"], f["ins"], f["ob"],
                                            n, w, f["sig"]))
            self.pu1, self.pu2 = pu(f1, S1, n1, al1), pu(f2, S2, n2, al2)

    def _contrafold(self, tt, S1, S2, n1, n2, max_w, need_acc,
                    use_pf_duplex, use_contraduplex, dev):
        """bpp and pu from the CRF; hp from the cofold, the duplex sweep or
        the CRF duplex engine (ractip_tpu/pipeline/ractip.py:88-122)."""
        bpp1 = cf_base_pair_probs(S1[0], self.n1, device=dev)
        bpp2 = cf_base_pair_probs(S2[0], self.n2, device=dev)
        if use_contraduplex:
            hp = cd_hybrid_probs(S1[0], S2[0], self.n1, self.n2,
                                 device=dev)[None]
        elif use_pf_duplex:
            hp = batch_duplex(tt, S1, S2, n1, n2).pr
        else:
            hp = batch_cofold(tt, S1, S2, n1, n2, dev)["hp"]
        self.hp = _host(hp)
        self.bpp1, self.bpp2 = bpp1.cpu().numpy(), bpp2.cpu().numpy()
        self.pu1 = self.pu2 = None
        if need_acc:
            def pu(bpp):
                out = np.zeros((bpp.shape[0], max(1, max_w) + 1))
                out[:, 1] = cf_unpaired_probs(bpp).cpu().numpy()
                return out
            self.pu1, self.pu2 = pu(bpp1), pu(bpp2)

    @classmethod
    def from_matrices(cls, bpp1, bpp2, hp, pu1=None, pu2=None):
        """External probability source (e.g. io.rip tables, reference
        src/ractip.cpp:461-514); accessibility defaults to unavailable."""
        self = cls.__new__(cls)
        self.n1, self.n2 = bpp1.shape[0], bpp2.shape[0]
        self.L1, self.L2 = bucket_length(self.n1), bucket_length(self.n2)
        self.bpp1, self.bpp2, self.hp = (np.asarray(bpp1), np.asarray(bpp2),
                                         np.asarray(hp))
        self.pu1, self.pu2 = pu1, pu2
        return self


def _chosen_regions(prob: JointProblem, uk, which: str):
    p, q = getattr(prob, which + "p"), getattr(prob, which + "q")
    return [(int(p[k]), int(q[k])) for k in np.where(uk > 0.5)[0]]


def solve_pair(params: EnergyParams, fa1: Fasta, fa2: Fasta, opts: Options,
               post: Posteriors | None = None, want_energy: bool = False,
               device="cuda"):
    """The reference's RactIP::solve.  Returns (r1, r2, obj, (e1,e2,e3), post)."""
    cfg = opts.solver_cfg()
    if post is None:
        post = Posteriors(params, fa1.seq, fa2.seq, opts.max_w,
                          cfg.accessibility,
                          use_pf_duplex=opts.use_pf_duplex,
                          cstr1=fa1.str_ if opts.use_constraint else None,
                          cstr2=fa2.str_ if opts.use_constraint else None,
                          use_contrafold=opts.use_contrafold,
                          use_contraduplex=opts.use_contraduplex,
                          device=device)
    n1, n2 = post.n1, post.n2
    prob = build_problem(post.bpp1, post.bpp2, post.hp, post.pu1, post.pu2,
                         n1, n2, cfg, fa1.str_, fa2.str_)
    u, obj, _bound, _nodes = exact_solve(prob, cfg, post.L1, post.L2,
                                         device=device)
    r1, r2 = decode_brackets(prob, u, n1, n2, cfg.in_pk and cfg.structure)

    e1 = e2 = e3 = None
    S1, S2 = encode(fa1.seq), encode(fa2.seq)
    if want_energy:
        # ops energies are in dekacal/mol; report kcal/mol like the reference
        e3 = eos.duplex_structure_energy(params, S1, S2, r1, r2) / 100.0
        kt = (params.temperature + 273.15) * 1.98717 / 1000.0
        if cfg.structure:
            e1 = eos.structure_energy(
                params, S1, eos.parse_pairs(r1)) / 100.0
            e2 = eos.structure_energy(
                params, S2, eos.parse_pairs(r2)) / 100.0
        else:
            # accessibility energy: -kT log up over chosen regions (:1272-1283)
            e1 = sum(-np.log(post.pu1[p, q - p + 1]) * kt
                     for p, q in _chosen_regions(prob, u[3], "v"))
            e2 = sum(-np.log(post.pu2[p, q - p + 1]) * kt
                     for p, q in _chosen_regions(prob, u[4], "w"))

    if cfg.acc_max and cfg.acc_max_ss:
        # re-fold the non-accessible remainder (:1263-1271, :1308-1316)
        keep1 = np.ones(n1, bool)
        for p, q in _chosen_regions(prob, u[3], "v"):
            keep1[p: q + 1] = False
        keep2 = np.ones(n2, bool)
        for p, q in _chosen_regions(prob, u[4], "w"):
            keep2[p: q + 1] = False
        r1s, obj1, _ = solve_ss(params, fa1.seq, opts, post.bpp1,
                                L=post.L1, allowed=keep1, device=device)
        r2s, obj2, _ = solve_ss(params, fa2.seq, opts, post.bpp2,
                                L=post.L2, allowed=keep2, device=device)
        obj += obj1 + obj2
        r1 = "".join(a if a != "." else b for a, b in zip(r1, r1s))
        r2 = "".join(a if a != "." else b for a, b in zip(r2, r2s))

    return r1, r2, obj, (e1, e2, e3), post


def solve_ss(params: EnergyParams, s: str, opts: Options, bpp: np.ndarray,
             L: int, allowed: np.ndarray | None = None,
             want_energy: bool = False, device="cuda"):
    """Secondary-structure-only optimization (reference solve_ss :1366-1465)
    on the strand's posteriors bpp ([L, L]): x variables only,
    at-most-one-pairing + optional stacking rows; NO pseudoknot exclusion
    (faithful to the reference model).  `device` runs the branch-and-bound's
    LPs where RACTIP_TPU_EXACT_BACKEND selects it."""
    n = len(s)
    if allowed is not None:
        bpp = bpp * np.outer(allowed, allowed)
    cfg = SolverConfig(min_w=0, max_w=0, in_pk=False,
                       stacking=opts.stacking, th_ss=opts.th_ss)
    prob = build_problem(bpp, np.zeros((1, 1)), np.zeros((n, 1)),
                         None, None, n, 1, cfg)
    u, obj, _bound, _nodes = exact_solve(prob, cfg, L, 8, device=device)
    r = decode_brackets(prob, u, n, 1, True)[0]
    e = None
    if want_energy:
        e = eos.structure_energy(params, encode(s), eos.parse_pairs(r)) / 100.0
    return r, obj, e


def predict(fa1: Fasta, fa2: Fasta, opts: Options | None = None,
            params: EnergyParams | None = None, device="cuda") -> Prediction:
    """The reference's run(): predict, optionally with energies and the
    sequential z-score (decoys carry no constraint string)."""
    opts = opts or Options()
    params = params or get_default_params()
    want_e = opts.show_energy or opts.zscore in (1, 2, 12)

    r1, r2, obj, (e1, e2, e3), post = solve_pair(
        params, fa1, fa2, opts, want_energy=want_e, device=device)
    pred = Prediction(r1=r1, r2=r2, objective=obj, e1=e1, e2=e2, e3=e3)

    if want_e:
        _, _, pred.e1s = solve_ss(params, fa1.seq, opts, post.bpp1,
                                  L=post.L1, want_energy=True, device=device)
        _, _, pred.e2s = solve_ss(params, fa2.seq, opts, post.bpp2,
                                  L=post.L2, want_energy=True, device=device)

    if opts.zscore in (1, 2, 12):
        rng = np.random.default_rng(opts.seed if opts.seed else None)
        e = pred.e1 + pred.e2 + pred.e3
        es = e - pred.e1s - pred.e2s
        s1, s2 = fa1.seq, fa2.seq
        acc = np.zeros(2)
        acc2 = np.zeros(2)
        for _ in range(opts.num_shuffling):
            t1 = dinuc_shuffle(s1, rng) if opts.zscore in (1, 12) else s1
            t2 = dinuc_shuffle(s2, rng) if opts.zscore in (2, 12) else s2
            _, _, _, (ee1, ee2, ee3), spost = solve_pair(
                params, Fasta("s1", t1), Fasta("s2", t2), opts,
                want_energy=True, device=device)
            _, _, ee1s = solve_ss(params, t1, opts, spost.bpp1,
                                  L=spost.L1, want_energy=True, device=device)
            _, _, ee2s = solve_ss(params, t2, opts, spost.bpp2,
                                  L=spost.L2, want_energy=True, device=device)
            ee = ee1 + ee2 + ee3
            ees = ee - ee1s - ee2s
            acc += (ee, ee * ee)
            acc2 += (ees, ees * ees)
        m, m2 = acc / opts.num_shuffling
        v = max(m2 - m * m, 0.0)
        ms, ms2 = acc2 / opts.num_shuffling
        vs = max(ms2 - ms * ms, 0.0)
        pred.zscore = ((e - m) / np.sqrt(v) if v else np.inf,
                       (es - ms) / np.sqrt(vs) if vs else np.inf)
    return pred
