"""Port single-pair exact path (ractip_tpu_torch.pipeline.ractip) vs the JAX
package.

The host modules (constraint masks, the RIP loader, the Vienna parameter
file, the host problem assembly) are numpy-level: they go through both
packages on the same inputs and must agree exactly.  The DP-driven parts
are held against tests/data/torch_port_golden_single.json, which
tools/make_torch_single_golden.py wrote from the JAX package's own
single-pair path, so no JAX DP is compiled here:

  * Posteriors (plain versions of K1-K5 on the CPU) on R1inv x R2inv with
    constraint strings: rtol 1e-4, atol 1e-6 on bpp1 bpp2 hp pu1 pu2; a
    strand banned whole has bpp exactly 0 and no NaN, and the unpaired
    probabilities of its masked fold are 1;
  * the golden's cases b-g and j (-c, --force-constraint, --duplex, the
    solver flags, --rip, -P, and --acc-max --acc-max-ss on pairs cut to a
    multiple of 32) for the short pairs (and --rip on CopA x CopT, which
    runs no DP, and CopA x CopT cut to 64 bases), each through the CLI's routing (cli.run_pair): brackets
    identical, objective within 1e-4, energies within 1e-6 kcal/mol, and
    where the JAX package raises, the same exception with the same
    message;
  * the sequential z-score (case h, 8 seeded decoys): z and zs within 1e-4.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ractip_tpu.io.rip import load_rip as jax_load_rip
from ractip_tpu.ops import constraints as jc
from ractip_tpu.params import vienna_par as jv
from ractip_tpu.params.tables import get_default_params as jax_params
from ractip_tpu.solver.candidates import SolverConfig as JaxCfg
from ractip_tpu.solver.candidates import build_problem as jax_build_problem
from ractip_tpu_torch import cli
from ractip_tpu_torch.evaluate.corpus import corpus_pairs
from ractip_tpu_torch.io.fasta import Fasta
from ractip_tpu_torch.io.rip import load_rip
from ractip_tpu_torch.ops import constraints as tcn
from ractip_tpu_torch.ops.accessibility import unpaired_probs
from ractip_tpu_torch.ops.scan import as_tables, batch_fold
from ractip_tpu_torch.ops.seq import encode
from ractip_tpu_torch.params import vienna_par as tv
from ractip_tpu_torch.params.tables import get_default_params
from ractip_tpu_torch.pipeline import ractip as tr
from ractip_tpu_torch.solver.candidates import SolverConfig, build_problem

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "data",
                       "torch_port_golden_single.json")) as _fh:
    GOLD = json.load(_fh)
SHORT = ("Tar-Tarstar", "R1inv-R2inv", "DIS-DIS")
PAIRS = {name: (fa1, fa2) for name, fa1, fa2 in corpus_pairs()}
ENERGIES = ("e1", "e2", "e3", "e1s", "e2s")


def golden_pair(e):
    """The golden entry's two strands: cut to their first e["cut"] bases
    where it says so, with its -c strings."""
    fa1, fa2 = PAIRS[e["pair"]]
    cut = e.get("cut")
    cstr = e["cstr"] or ("", "")
    return (Fasta(fa1.name, fa1.seq[:cut], cstr[0]),
            Fasta(fa2.name, fa2.seq[:cut], cstr[1]))


def run_case(e, device="cpu"):
    """One golden entry through the port's CLI routing (cli.run_pair):
    (r1, r2, objective, energies or None, zscore or None)."""
    flags = [os.path.join(ROOT, f) if f in (e["par"], e["rip"]) else f
             for f in e["flags"]]
    args = cli.build_parser().parse_args(["a", "b", "--device", device]
                                         + flags)
    r1, r2, obj, ee, z = cli.run_pair(args, *golden_pair(e))
    en = None if ee is None else [ee[k] for k in ENERGIES]
    return r1, r2, obj, en, z


def check_case(e, got):
    r1, r2, obj, en, _ = got
    tag = f"{e['case']} {e['pair']} {e['flags']}"
    assert (r1, r2) == (e["r1"], e["r2"]), tag
    assert abs(obj - e["objective"]) <= 1e-4, tag
    if e["energies"] is not None:
        np.testing.assert_allclose(en, e["energies"], rtol=0, atol=1e-6,
                                   err_msg=tag)


def _strings():
    """Every golden constraint string pair, plus the edge strings."""
    out = [tuple(v) for v in GOLD["constraints"].values()]
    out += [("[" * 21, "]" * 19), ("x" * 21, ""), ("", ")((<.>|"),
            ("((..))..(", "..)..((.)")]
    return out


def test_host_modules_match_jax():
    # constraint masks: fold and concatenation coordinates (L = L1 + L2)
    for s1, s2 in _strings():
        n1, n2 = len(s1) or 21, len(s2) or 19
        L1, L2 = 32 * -(-n1 // 32), 32 * -(-n2 // 32)
        for s, n, L in ((s1, n1, L1), (s2, n2, L2)):
            a, b = tcn.fold_allow(s, n, L), jc.fold_allow(s, n, L)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tcn.cofold_allow(s1, s2, n1, n2, L1 + L2),
            jc.cofold_allow(s1, s2, n1, n2, L1 + L2))
    # RIP tables
    for name in ("Tar-Tarstar", "CopA-CopT"):
        fa1, fa2 = PAIRS[name]
        path = os.path.join(ROOT, "tests", "data", f"rip_{name}.txt")
        for a, b in zip(load_rip(path, len(fa1.seq), len(fa2.seq)),
                        jax_load_rip(path, len(fa1.seq), len(fa2.seq))):
            np.testing.assert_array_equal(a, b)
    # the Vienna parameter file: parse, apply, write
    with open(os.path.join(ROOT, "tests", "data", "single.par")) as fh:
        text = fh.read()
    pa, pb = tv.parse_par(text), jv.parse_par(text)
    assert pa.ignored == pb.ignored and set(pa.tables) == set(pb.tables)
    for k in pa.tables:
        np.testing.assert_array_equal(np.asarray(pa.tables[k], object),
                                      np.asarray(pb.tables[k], object), k)
    qa = tv.apply_par(get_default_params(), pa)
    qb = jv.apply_par(jax_params(), pb)
    for f in dataclasses.fields(qa):
        np.testing.assert_array_equal(getattr(qa, f.name),
                                      getattr(qb, f.name), f.name)
    assert tv.write_par(qa) == jv.write_par(qb)
    # the host problem, with and without --force-constraint
    post = GOLD["cases"]["i"]["partial"]
    m = {k: np.asarray(post[k], np.float32)
         for k in ("bpp1", "bpp2", "hp", "pu1", "pu2")}
    s1, s2 = post["cstr"]
    for kw in (dict(), dict(force_constraint=True),
               dict(force_constraint=True, acc_max=True, beta=0.1),
               dict(in_pk=False, stacking=False, acc_num=2)):
        a = build_problem(m["bpp1"], m["bpp2"], m["hp"], m["pu1"], m["pu2"],
                          len(s1), len(s2), SolverConfig(**kw), s1, s2)
        b = jax_build_problem(m["bpp1"], m["bpp2"], m["hp"], m["pu1"],
                              m["pu2"], len(s1), len(s2), JaxCfg(**kw), s1,
                              s2)
        for f in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)), f)


def test_posteriors_match_golden():
    params = get_default_params()
    fa1, fa2 = PAIRS["R1inv-R2inv"]
    for label in ("partial", "banned"):
        g = GOLD["cases"]["i"][label]
        post = tr.Posteriors(params, fa1.seq, fa2.seq, g["max_w"], True,
                             cstr1=g["cstr"][0], cstr2=g["cstr"][1],
                             device="cpu")
        for k in ("bpp1", "bpp2", "hp", "pu1", "pu2"):
            got = getattr(post, k)
            assert np.isfinite(got).all(), (label, k)
            np.testing.assert_allclose(got, np.asarray(g[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{label} {k}")
    # strand 1 banned whole: no pair, in the fold and across the cut
    assert not post.bpp1.any() and not post.hp.any()
    # the masked fold's own unpaired probabilities are all 1 (Posteriors'
    # pu comes from the unconstrained fold, as the reference's pf_unstru)
    tt = as_tables(params, "cpu")
    L, n = post.L1, torch.tensor([post.n1])
    allow = torch.as_tensor(tcn.fold_allow("x" * post.n1, post.n1, L)[None])
    f = batch_fold(tt, encode(fa1.seq, L)[None], n, "cpu", allow=allow)
    assert not f["bpp"].any() and torch.isfinite(f["ins"]["zn"]).all()
    pu = unpaired_probs(tt, f["ff"], f["ins"], f["ob"], n, 15, f["sig"])
    for w in range(1, 16):
        np.testing.assert_allclose(pu[0, : post.n1 - w + 1, w].numpy(), 1.0,
                                   rtol=1e-6)


def test_predict_matches_golden():
    n = 0
    for case in "bcdefgj":
        for e in GOLD["cases"][case]:
            if e["pair"] not in SHORT and not (e["rip"] or e.get("cut")):
                continue
            n += 1
            if e.get("error"):
                with pytest.raises(Exception) as ex:
                    run_case(e)
                assert type(ex.value).__name__ == e["error"]
                assert str(ex.value) == e["message"]
                continue
            check_case(e, run_case(e))
    assert n == 28


def test_sequential_zscore_matches_golden():
    e, = GOLD["cases"]["h"]
    got = run_case(e)
    check_case(e, got)
    np.testing.assert_allclose(got[4], e["zscore"], rtol=0, atol=1e-4)
