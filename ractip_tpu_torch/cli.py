"""Command-line interface of the port.

Mirrors ractip_tpu/cli.py (:138-270) and routes as it does: --rip solves
the pair on imported posteriors; --zscore runs the batched decoy sweep
(pipeline/batched.py, resumable with --ckpt-dir) unless --no-batch, the
CONTRAfold model (--contrafold, --contraduplex), or -c with constraint
strings sends it through the sequential loop of the single-pair exact path
(pipeline/ractip.py::predict), which also serves every run without
--zscore.  --mesh, which the port does not carry yet, exits non-zero with
the ROADMAP item that will bring it; no flag is ignored quietly.

Usage: python -m ractip_tpu_torch.cli A.fa B.fa [-e] [-c] [--zscore 12] ...
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from .io.fasta import load_fasta
from .params.tables import get_default_params
from .pipeline.batched import zscore_batch
from .pipeline.options import Options
from .pipeline.ractip import Posteriors, predict, solve_pair
from .utils.timing import StageTimer, stage

# reference flags outside the port -> the ROADMAP item that ports them
NOT_PORTED = {
    "mesh": ("--mesh", "queue 1 item 4 (multi-GPU)"),
}
# the sections a complete Vienna parameter dump defines
CORE_SECTIONS = {"stack", "mismatch_h", "mismatch_i", "dangle5", "dangle3",
                 "int11", "int21", "int22", "hairpin", "bulge", "internal",
                 "ml", "ninio", "misc"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ractip-tpu-torch",
        description="RactIP on PyTorch + CUDA: RNA-RNA interaction "
                    "prediction (port of ractip_tpu).")
    ap.add_argument("fasta", nargs="+",
                    help="two FASTA files, or one FASTA with two records")
    ap.add_argument("-a", "--alpha", type=float, default=0.7,
                    help="weight for hybridization")
    ap.add_argument("-b", "--beta", type=float, default=0.0,
                    help="weight for accessibility")
    ap.add_argument("-t", "--fold-th", type=float, default=0.5,
                    help="threshold for base-pairing probabilities")
    ap.add_argument("-u", "--hybridize-th", type=float, default=0.1,
                    help="threshold for hybridization probabilities")
    ap.add_argument("-s", "--acc-th", type=float, default=0.003,
                    help="threshold for accessible probabilities")
    ap.add_argument("--acc-max", action="store_true",
                    help="optimize for accessibility instead of internal "
                         "secondary structures")
    ap.add_argument("--acc-max-ss", action="store_true",
                    help="additional prediction of internal secondary "
                         "structures")
    ap.add_argument("--acc-num", type=int, default=1,
                    help="the number of accessible regions (0=unlimited)")
    ap.add_argument("--max-w", type=int, default=15,
                    help="maximum length of accessible regions")
    ap.add_argument("--min-w", type=int, default=5,
                    help="minimum length of accessible regions")
    ap.add_argument("--zscore", type=int, default=0, choices=(0, 1, 2, 12),
                    help="z-score via dishuffling (1=1st, 2=2nd, 12=both)")
    ap.add_argument("--num-shuffling", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-c", "--use-constraint", action="store_true",
                    help="use structure constraints")
    ap.add_argument("--force-constraint", action="store_true",
                    help="enforce structure constraints")
    ap.add_argument("--allow-isolated", action="store_true",
                    help="allow isolated base-pairs")
    ap.add_argument("-e", "--show-energy", action="store_true",
                    help="free energy of the predicted joint structure")
    ap.add_argument("-P", "--param-file", type=str, default=None,
                    help="energy parameter file (Vienna format)")
    ap.add_argument("--no-pk", action="store_true",
                    help="no constraints for internal pseudoknots")
    ap.add_argument("-r", "--rip", type=str, default=None,
                    help="import posterior probabilities from a RIP result")
    ap.add_argument("--duplex", action="store_true",
                    help="pure-duplex hybridization model (pf_duplex) in "
                         "place of the cofold")
    ap.add_argument("--no-bl", action="store_true",
                    help="do not use BL parameters (needs -P)")
    ap.add_argument("--contrafold", action="store_true",
                    help="use CONTRAfold's learned model for the base-pairing "
                         "and accessibility posteriors")
    ap.add_argument("--contraduplex", action="store_true",
                    help="hybridization posteriors from CONTRAfold's duplex "
                         "engine (the reference ships this engine but never "
                         "calls it); implies --contrafold")
    ap.add_argument("--batch", dest="batch", action="store_true", default=True,
                    help="batch the z-score sweep on the device (default)")
    ap.add_argument("--no-batch", dest="batch", action="store_false",
                    help="run the z-score sweep through the sequential "
                         "exact path")
    ap.add_argument("--chunk", type=int, default=256,
                    help="device batch chunk size")
    ap.add_argument("--ckpt-dir", type=str, default=None, metavar="DIR",
                    help="checkpoint directory for the batched decoy sweep; "
                         "a killed run resumes after the last completed "
                         "chunk")
    ap.add_argument("--exact-gap-tol", type=float, default=1e-4,
                    metavar="TOL",
                    help="certified-exactness tolerance on the batched "
                         "path: instances whose device objective trails "
                         "the LP bound by more than TOL re-solve on the "
                         "host (HiGHS) (<=0 disables, accepting "
                         "uncertified device solutions)")
    ap.add_argument("--timings", action="store_true",
                    help="print per-stage wall times to stderr")
    ap.add_argument("--records", type=str, default=None, metavar="PATH",
                    help="append a structured JSONL result record to PATH")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--mesh", action="store_true", help=argparse.SUPPRESS)
    return ap


def options_from_args(args) -> Options:
    return Options(
        alpha=args.alpha, beta=args.beta, th_ss=args.fold_th,
        th_hy=args.hybridize_th, th_ac=args.acc_th,
        max_w=args.max_w, min_w=args.min_w, acc_num=args.acc_num,
        acc_max=args.acc_max, acc_max_ss=args.acc_max_ss,
        in_pk=not args.no_pk, stacking=not args.allow_isolated,
        force_constraint=args.force_constraint,
        zscore=args.zscore, num_shuffling=args.num_shuffling,
        seed=args.seed, show_energy=args.show_energy,
        use_constraint=args.use_constraint, use_pf_duplex=args.duplex,
        use_contrafold=args.contrafold,
        use_contraduplex=args.contraduplex)


def _fmt_sum(parts: list[float]) -> str:
    out = f"{parts[0]:g}"
    for p in parts[1:]:
        out += ("+" if p >= 0 else "") + f"{p:g}"
    return out


def load_params(path: str | None, no_bl: bool):
    """The energy parameters: BL*, overridden section by section by a
    Vienna parameter file (reference src/ractip.cpp:1565-1569).  With
    no_bl, sections the file omits keep their BL* values: say so."""
    params = get_default_params()
    if not path:
        return params
    from .params.vienna_par import load_param_file, parse_par
    if no_bl:
        with open(path) as fh:
            present = set(parse_par(fh.read()).tables)
        missing = sorted(CORE_SECTIONS - present)
        if missing:
            print(f"ractip-tpu-torch: --no-bl: {path} does not define "
                  f"{', '.join(missing)}; those sections keep BL* values",
                  file=sys.stderr)
    return load_param_file(path, params)


def run_pair(args, fa1, fa2, timer=None):
    """One pair, routed as ractip_tpu/cli.py:138-270 routes it: (r1, r2,
    objective, energies, zscore).  --rip solves the pair on the imported
    posteriors (objective only); --zscore runs the batched decoy sweep
    (energies e, es; no objective; --ckpt-dir makes it resumable) unless
    --no-batch, the CONTRAfold model, or -c with constraint strings sends
    it through the sequential z-score of the single-pair exact path, which
    serves every other run (energies e1 e2 e3 e1s e2s with -e or
    --zscore)."""
    opts = options_from_args(args)
    params = load_params(args.param_file, args.no_bl)
    dev = args.device
    if args.rip:
        # external probability source; no accessibility tables available
        from .io.rip import load_rip
        opts = dataclasses.replace(opts, max_w=0, min_w=0)
        post = Posteriors.from_matrices(*load_rip(args.rip, len(fa1.seq),
                                                  len(fa2.seq)))
        r1, r2, obj, _, _ = solve_pair(params, fa1, fa2, opts, post=post)
        return r1, r2, float(obj), None, None

    # the batched path carries neither constraint masks nor the CONTRAfold
    # model: those take the sequential exact path, as the reference honours
    # -c and --contrafold in z-score runs
    can_batch = (args.batch and not opts.use_contrafold
                 and not opts.use_contraduplex
                 and not (opts.use_constraint and (fa1.str_ or fa2.str_)))
    if args.zscore in (1, 2, 12) and can_batch:
        gap_tol = args.exact_gap_tol if args.exact_gap_tol > 0 else None
        z, zs, st = zscore_batch(fa1, fa2, opts, params, chunk=args.chunk,
                                 ckpt_dir=args.ckpt_dir,
                                 exact_gap_tol=gap_tol, timer=timer,
                                 device=dev)
        return (*st["brackets"], None,
                dict(e=float(st["e"]), es=float(st["es"])),
                (float(z), float(zs)))
    if args.zscore in (1, 2, 12) and args.batch:
        print("ractip-tpu-torch: -c/--contrafold not supported on the "
              "batched z-score path; falling back to the sequential path",
              file=sys.stderr)
    with stage(timer, "predict"):
        pred = predict(fa1, fa2, opts, params, device=dev)
    ee = None
    if pred.e1 is not None:
        ee = {k: float(getattr(pred, k))
              for k in ("e1", "e2", "e3", "e1s", "e2s")}
    return pred.r1, pred.r2, float(pred.objective), ee, pred.zscore


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    for dest, (name, item) in NOT_PORTED.items():
        if getattr(args, dest) not in (None, False):
            print(f"ractip-tpu-torch: {name} is not ported yet "
                  f"(ROADMAP.md {item})", file=sys.stderr)
            return 2
    if args.no_bl and not args.param_file:
        # the reference's --no-bl keeps ViennaRNA's built-in Turner tables,
        # which are library data and not bundled: a complete dump via -P
        # reproduces it (applied instead of the BL* set)
        print("ractip-tpu-torch: --no-bl needs -P <file> with a complete "
              "Vienna-format parameter dump (e.g. rna_turner2004.par); "
              "the Turner tables are ViennaRNA library data and are not "
              "bundled here", file=sys.stderr)
        return 1
    if len(args.fasta) >= 2:
        fa1 = load_fasta(args.fasta[0])[0]
        fa2 = load_fasta(args.fasta[1])[0]
    else:
        recs = load_fasta(args.fasta[0])
        if len(recs) < 2:
            print(f"{args.fasta[0]}: Format error", file=sys.stderr)
            return 1
        fa1, fa2 = recs[0], recs[1]
    timer = StageTimer(args.device) if args.timings else None
    r1, r2, obj, ee, z = run_pair(args, fa1, fa2, timer)
    print(f">{fa1.name}\n{fa1.seq}\n{r1}")
    print(f">{fa2.name}\n{fa2.seq}\n{r2}")
    if args.rip:
        return 0        # the reference's --rip reports the structures only
    if args.show_energy and "e" in ee:
        print(f"(E: JS= {ee['e']:g}, JS-S1-S2= {ee['es']:g})")
    elif args.show_energy:
        e123, ess = [ee[k] for k in ("e1", "e2", "e3")], [ee["e1s"],
                                                          ee["e2s"]]
        print(f"(E: JS= {sum(e123):g} = {_fmt_sum(e123)}, "
              f"S1+S2= {sum(ess):g} = {_fmt_sum(ess)})")
    if z is not None:
        print(f"z-score: {z[0]:g}, {z[1]:g}")
    if args.records:
        from .utils.records import PairRecord, write_records
        rec = PairRecord(
            name1=fa1.name, name2=fa2.name, seq1=fa1.seq, seq2=fa2.seq,
            r1=r1, r2=r2, objective=obj, energies=ee, zscore=z,
            timings=timer.report() if timer else None)
        write_records(args.records, [rec], append=True)
    if timer:
        print(f"timings: {timer.json()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
