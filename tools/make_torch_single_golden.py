#!/usr/bin/env python
"""Write tests/data/torch_port_golden_single.json from the JAX package on the CPU.

The golden file holds what the PyTorch port's single-pair exact path
(ractip_tpu_torch.pipeline.ractip.predict) must reproduce, with the JAX
package's own single-pair path (ractip_tpu.pipeline.ractip.predict: the
fori_loop DPs, the host HiGHS MILP, solve_ss and the energies) as the
reference.  Each case is a pair, a list of the CLI's flags and, where -c
is among them, the two constraint strings; it records the brackets, the
objective and the energies e1 e2 e3 e1s e2s (or the exception the JAX
package raises):

  a  the 8 corpus pairs, -e;
  b  the 8 corpus pairs, -e -c, with constraint strings derived from (a)'s
     structures (constraint_strings below; every character that
     ops/constraints.py handles appears, and RyhB is banned whole);
  c  (b) with --force-constraint;
  d  (b) with --duplex;
  e  --no-pk --allow-isolated --acc-num 2, --acc-max -b 0.1, and
     --acc-max --acc-max-ss -b 0.1, on Tar-Tarstar, R1inv-R2inv and DIS-DIS
     (the last raises in the JAX package wherever n is not a multiple of
     32: solve_ss masks the bucket-sized bpp with an n-sized mask);
  f  --rip with the RIP-format tables this tool writes (Tar-Tarstar and
     CopA-CopT; brackets and objective, as the CLI's --rip path reports);
  g  -P, and --no-bl -P, with the Vienna-format parameter file this tool
     writes, on Tar-Tarstar, R1inv-R2inv and DIS-DIS;
  h  -c --zscore 12 --num-shuffling 8 --seed 11 on R1inv-R2inv: z and zs;
  i  the L = 32 posterior matrices (bpp1 bpp2 hp pu1 pu2) of Posteriors for
     R1inv-R2inv with (b)'s constraint strings, and with strand 1 banned
     whole;
  j  -e --acc-max --acc-max-ss -b 0.1 on DIS-DIS cut to 32 bases and
     CopA-CopT cut to 64 (each strand's first bases; the entry's "cut"),
     lengths at which the JAX package runs the remainder's re-fold and
     merges its brackets.

Inputs written beside the golden file (nothing is downloaded):
  rip_<pair>.txt   RIP-format tables (sections "Table R:", "Table S:",
                   "Table I:"; 1-based rows, strand 2 numbered 3'->5') of the
                   JAX package's unconstrained posteriors above 1e-4;
  single.par       write_par of the BL* parameters with every finite hairpin
                   entry raised by 50 dekacal/mol (stated in the file).

Each run of the JAX package goes to a child process of its own, up to
--jobs at a time: this jaxlib's XLA:CPU compile path fails after a few
compiles in one process (tests/conftest.py), and every single-pair run
compiles its DPs anew.  So case h runs predict's sequential z-score loop
(ractip_tpu/pipeline/ractip.py:291-319) here, the decoys drawn in its order
from its generator and each decoy's solve_pair and solve_ss in a child.

Usage:  JAX_PLATFORMS=cpu python tools/make_torch_single_golden.py
        [--cases a,b,...]   (recompute only these; the file's other cases
        are kept; b-i derive their strings from the file's case a)
        [--jobs N]          (child processes at a time, default 4)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from ractip_tpu import native  # noqa: E402
from ractip_tpu.cli import build_parser, options_from_args  # noqa: E402
from ractip_tpu.evaluate.corpus import corpus_pairs  # noqa: E402
from ractip_tpu.io.fasta import Fasta  # noqa: E402
from ractip_tpu.io.rip import load_rip  # noqa: E402
from ractip_tpu.params.tables import get_default_params  # noqa: E402
from ractip_tpu.params.vienna_par import load_param_file, write_par  # noqa: E402
from ractip_tpu.pipeline.ractip import (Posteriors, predict, solve_pair,  # noqa: E402
                                        solve_ss)
from ractip_tpu.pipeline.shuffle import dinuc_shuffle  # noqa: E402

DATA = os.path.join(ROOT, "tests", "data")
OUT = os.path.join(DATA, "torch_port_golden_single.json")
SHORT = ("Tar-Tarstar", "R1inv-R2inv", "DIS-DIS")
RIP_PAIRS = ("Tar-Tarstar", "CopA-CopT")
ZSCORE_PAIR = "R1inv-R2inv"
PAR = "single.par"
HAIRPIN_DELTA = 50
OPTION_SETS = (["-e", "--no-pk", "--allow-isolated", "--acc-num", "2"],
               ["-e", "--acc-max", "-b", "0.1"],
               ["-e", "--acc-max", "--acc-max-ss", "-b", "0.1"])
CUT_PAIRS = (("DIS-DIS", 32), ("CopA-CopT", 64))
ALL_CASES = "abcdefghij"


def _mates(s: str) -> dict[int, int]:
    st, out = [], {}
    for i, ch in enumerate(s):
        if ch == "(":
            st.append(i)
        elif ch == ")" and st:
            j = st.pop()
            out[i], out[j] = j, i
    return out


def _free(s: list[str], k: int) -> list[int]:
    """k positions of s holding '.', freeing outermost '(' ')' pairs (both
    ends become '.') while there are too few."""
    while sum(ch == "." for ch in s) < k:
        mates = _mates("".join(s))
        i = min(p for p in mates if s[p] == "(")
        s[i] = s[mates[i]] = "."
    return [p for p, ch in enumerate(s) if ch == "."]


def constraint_strings(name: str, r1: str, r2: str) -> tuple[str, str]:
    """The -c strings of case b, from case a's structures r1, r2: the
    helices and interaction sites of (a), edited per pair so that every
    character of the Vienna alphabet that ops/constraints.py handles
    appears: 'x', matched and unmatched '(' ')', '<', '>', '|', '[', ']',
    and 'e', 'l' of the reference's rewrites."""
    s1, s2 = list(r1), list(r2)
    if name == "CopA-CopT":
        for p in _free(s1, 3)[:3]:
            s1[p] = "x"
        for p in _free(s2, 3)[-3:]:
            s2[p] = "x"
    elif name == "DIS-DIS":
        f = _free(s1, 2)
        s1[f[0]], s1[f[-1]] = "<", ">"
        for p in _free(s2, 2)[:2]:
            s2[p] = "|"
    elif name == "IncRNA54-RepZ":
        # an unmatched '(' before every bracket: the stack leaves it open
        s1[_free(s1, 1)[0]] = "("
        f = _free(s2, 4)
        s2[f[0]] = s2[f[1]] = "e"
        s2[f[-1]] = s2[f[-2]] = "l"
    elif name == "MicA-ompA":
        s1[_free(s1, 1)[0]] = "x"
        # an unmatched ')' after every bracket
        s2[_free(s2, 1)[-1]] = ")"
    elif name == "OxyS-fhlA":
        # keep the interaction sites of strand 2 at the larger half of j only
        js = [p for p, ch in enumerate(s2) if ch == "]"]
        for p in js[: len(js) - (len(js) + 1) // 2]:
            s2[p] = "."
    elif name == "R1inv-R2inv":
        f = _free(s2, 2)
        s2[f[0]], s2[f[-1]] = "x", "l"
    elif name == "RyhB-SodB":
        s1 = ["x"] * len(s1)
    return "".join(s1), "".join(s2)


def _opts(flags: list[str]):
    return options_from_args(build_parser().parse_args(["a", "b"] + flags))


def _energies(pred):
    if pred.e1 is None:
        return None
    return [float(x) for x in (pred.e1, pred.e2, pred.e3, pred.e1s,
                               pred.e2s)]


def _pair(name, cut=None):
    """The corpus pair, each strand cut to its first `cut` bases."""
    a, b = next((a, b) for n, a, b in corpus_pairs() if n == name)
    if cut:
        a, b = Fasta(a.name, a.seq[:cut]), Fasta(b.name, b.seq[:cut])
    return a, b


def _params(par):
    params = get_default_params()
    return load_param_file(os.path.join(ROOT, par), params) if par else params


def _entry(case, pair, flags, cstr=None, par=None, rip=None, zscore=True,
           cut=None):
    """One golden case, run as the CLI runs its flags (zscore=False: the
    real pair of a z-score run only)."""
    e = dict(case=case, pair=pair, flags=flags, cstr=cstr, par=par, rip=rip)
    if cut:
        e["cut"] = cut
    fa1, fa2 = _pair(pair, cut)
    if cstr is not None:
        fa1 = Fasta(fa1.name, fa1.seq, cstr[0])
        fa2 = Fasta(fa2.name, fa2.seq, cstr[1])
    opts = _opts(flags)
    if not zscore:
        opts = dataclasses.replace(opts, zscore=0, show_energy=True)
    params = _params(par)
    t0 = time.perf_counter()
    try:
        if rip is not None:
            opts = dataclasses.replace(opts, max_w=0, min_w=0)
            bp1, bp2, hp = load_rip(os.path.join(ROOT, rip), len(fa1.seq),
                                    len(fa2.seq))
            r1, r2, obj, _, _ = solve_pair(
                params, fa1, fa2, opts,
                post=Posteriors.from_matrices(bp1, bp2, hp))
            e.update(r1=r1, r2=r2, objective=float(obj), energies=None)
        else:
            pred = predict(fa1, fa2, opts, params)
            e.update(r1=pred.r1, r2=pred.r2, objective=float(pred.objective),
                     energies=_energies(pred))
            if pred.zscore is not None:
                e["zscore"] = [float(pred.zscore[0]), float(pred.zscore[1])]
    except Exception as ex:   # the port must raise the same
        e["error"] = type(ex).__name__
        e["message"] = str(ex)
    e["seconds"] = time.perf_counter() - t0
    return e


def _decoy(t1, t2, flags):
    """One decoy of predict's z-score loop: (ee, ees)."""
    opts = _opts(flags)
    params = get_default_params()
    _, _, _, (ee1, ee2, ee3), spost = solve_pair(
        params, Fasta("s1", t1), Fasta("s2", t2), opts, want_energy=True)
    _, _, ee1s = solve_ss(params, t1, opts, spost.bpp1, L=spost.L1,
                          want_energy=True)
    _, _, ee2s = solve_ss(params, t2, opts, spost.bpp2, L=spost.L2,
                          want_energy=True)
    ee = ee1 + ee2 + ee3
    return [float(ee), float(ee - ee1s - ee2s)]


def _posteriors(pair, cstr, max_w=15):
    fa1, fa2 = _pair(pair)
    post = Posteriors(get_default_params(), fa1.seq, fa2.seq, max_w, True,
                      cstr1=cstr and cstr[0], cstr2=cstr and cstr[1])
    return post


def _post_matrices(pair, cstr):
    post = _posteriors(pair, cstr)
    return dict(cstr=cstr, max_w=15, L1=post.L1, L2=post.L2,
                **{k: np.asarray(getattr(post, k), np.float64).tolist()
                   for k in ("bpp1", "bpp2", "hp", "pu1", "pu2")})


def _rip_file(pair):
    fa1, fa2 = _pair(pair)
    rel = os.path.join("tests", "data", f"rip_{pair}.txt")
    _write_rip(os.path.join(ROOT, rel), _posteriors(pair, None),
               len(fa1.seq), len(fa2.seq))
    return rel


CHILD = {"entry": _entry, "decoy": _decoy, "post": _post_matrices,
         "rip": _rip_file}


def _spawn(jobs, specs):
    """Run each (kind, kwargs) in a child process, jobs at a time, and
    return their results in order."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def one(spec):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", json.dumps(spec)],
                              capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=3600)
        if proc.returncode != 0:
            raise RuntimeError(f"{spec}: exit {proc.returncode}\n"
                               + proc.stderr[-3000:])
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"  {spec[0]} {json.dumps(spec[1])[:90]}: "
              f"{str(out)[:150]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        return out
    with ThreadPoolExecutor(jobs) as ex:
        return list(ex.map(one, specs))


def _write_rip(path, post, n1, n2, th=1e-4):
    lines = ["Table R:"]
    for i in range(n1):
        for j in range(i + 1, n1):
            if post.bpp1[i, j] > th:
                lines.append(f"{i + 1} {j + 1} {float(post.bpp1[i, j]):.9g}")
    lines.append("Table S:")
    for a in range(n2):
        for b in range(a + 1, n2):
            if post.bpp2[a, b] > th:
                lines.append(f"{n2 - b} {n2 - a} {float(post.bpp2[a, b]):.9g}")
    lines.append("Table I:")
    for a in range(n1):
        for b in range(n2):
            if post.hp[a, b] > th:
                lines.append(f"{a + 1} {n2 - b} {float(post.hp[a, b]):.9g}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _write_par(path, params):
    import dataclasses
    hp = np.asarray(params.hairpin).copy()
    hp[hp < 10000000] += HAIRPIN_DELTA
    text = write_par(dataclasses.replace(params, hairpin=hp))
    head, rest = text.split("\n", 1)
    note = (f"/* BL* parameters (ractip_tpu/params) with every finite "
            f"hairpin entry raised by {HAIRPIN_DELTA} dekacal/mol; written "
            f"by tools/make_torch_single_golden.py */")
    with open(path, "w") as fh:
        fh.write(f"{head}\n{note}\n{rest}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=ALL_CASES)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        kind, kw = json.loads(args.child)
        print(json.dumps(CHILD[kind](**kw)))
        return 0
    cases = [c for c in args.cases.replace(",", "")]

    import jax
    gold = {"generator": "tools/make_torch_single_golden.py",
            "jax_backend": jax.default_backend(),
            "native_shuffle": bool(native.available()), "cases": {}}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            gold = json.load(fh)
    names = [name for name, _, _ in corpus_pairs()]
    spawn = lambda specs: _spawn(args.jobs, specs)

    def save():
        gold["cases"] = dict(sorted(gold["cases"].items()))
        tmp = args.out + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(gold, fh, indent=1)
            fh.write("\n")
        os.replace(tmp, args.out)

    def run(case, fn):
        if case not in cases:
            return
        t0 = time.perf_counter()
        print(f"case {case}", flush=True)
        gold["cases"][case] = fn()
        save()
        print(f"case {case}: {time.perf_counter() - t0:.1f} s", flush=True)

    entry = lambda **kw: ("entry", kw)
    run("a", lambda: spawn([entry(case="a", pair=n, flags=["-e"])
                            for n in names]))
    strings = {e["pair"]: constraint_strings(e["pair"], e["r1"], e["r2"])
               for e in gold["cases"]["a"]}
    gold["constraints"] = strings
    for case, extra in (("b", []), ("c", ["--force-constraint"]),
                        ("d", ["--duplex"])):
        run(case, lambda extra=extra, case=case: spawn([
            entry(case=case, pair=n, flags=["-e", "-c"] + extra,
                  cstr=list(strings[n])) for n in names]))
    run("e", lambda: spawn([entry(case="e", pair=n, flags=flags)
                            for flags in OPTION_SETS for n in SHORT]))

    def rip_case():
        rels = spawn([("rip", dict(pair=n)) for n in RIP_PAIRS])
        return spawn([entry(case="f", pair=n, flags=["-r", rel], rip=rel)
                      for n, rel in zip(RIP_PAIRS, rels)])
    run("f", rip_case)

    def par_case():
        rel = os.path.join("tests", "data", PAR)
        _write_par(os.path.join(ROOT, rel), get_default_params())
        return spawn([entry(case="g", pair=n, flags=flags + ["-e", "-P", rel],
                            par=rel)
                      for flags in ([], ["--no-bl"]) for n in SHORT])
    run("g", par_case)

    def zscore_case():
        # predict's sequential z-score (ractip.py:291-319): the decoys in
        # its generator's order, unconstrained, each run in a child
        flags = ["-c", "--zscore", "12", "--num-shuffling", "8", "--seed",
                 "11"]
        opts = _opts(flags)
        cstr = list(strings[ZSCORE_PAIR])
        e, = spawn([entry(case="h", pair=ZSCORE_PAIR, flags=flags, cstr=cstr,
                          zscore=False)])
        fa1, fa2 = _pair(ZSCORE_PAIR)
        rng = np.random.default_rng(opts.seed if opts.seed else None)
        decoys = []
        for _ in range(opts.num_shuffling):
            t1 = dinuc_shuffle(fa1.seq, rng)
            t2 = dinuc_shuffle(fa2.seq, rng)
            decoys.append(("decoy", dict(t1=t1, t2=t2, flags=flags)))
        got = spawn(decoys)
        e1, e2, e3, e1s, e2s = e["energies"]
        ev = e1 + e2 + e3
        es = ev - e1s - e2s
        acc, acc2 = np.zeros(2), np.zeros(2)
        for ee, ees in got:
            acc += (ee, ee * ee)
            acc2 += (ees, ees * ees)
        m, m2 = acc / opts.num_shuffling
        v = max(m2 - m * m, 0.0)
        ms, ms2 = acc2 / opts.num_shuffling
        vs = max(ms2 - ms * ms, 0.0)
        e["zscore"] = [float((ev - m) / np.sqrt(v) if v else np.inf),
                       float((es - ms) / np.sqrt(vs) if vs else np.inf)]
        e["decoys"] = [[d[1]["t1"], d[1]["t2"]] for d in decoys]
        return [e]
    run("h", zscore_case)

    def post_case():
        n1 = len(_pair(ZSCORE_PAIR)[0].seq)
        labels = ("partial", "banned")
        cstrs = (list(strings[ZSCORE_PAIR]),
                 ["x" * n1, strings[ZSCORE_PAIR][1]])
        return dict(zip(labels, spawn([
            ("post", dict(pair=ZSCORE_PAIR, cstr=c)) for c in cstrs])))
    run("i", post_case)
    run("j", lambda: spawn([entry(case="j", pair=n, flags=OPTION_SETS[2],
                                  cut=cut) for n, cut in CUT_PAIRS]))
    save()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
