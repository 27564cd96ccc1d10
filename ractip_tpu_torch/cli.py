"""Command-line interface of the port (the slice's flags only).

Mirrors ractip_tpu/cli.py for the default model and the pure-duplex model
(--duplex): a single pair runs through the batched path at B=1; --zscore
runs the batched decoy sweep.  Flags of
the reference that the port does not carry yet exit non-zero with the
ROADMAP item that will bring them; none is ignored quietly.

Usage: python -m ractip_tpu_torch.cli A.fa B.fa [-e] [--zscore 12] ...
"""

from __future__ import annotations

import argparse
import sys

from .io.fasta import load_fasta
from .params.tables import get_default_params
from .pipeline.batched import predict_batch, zscore_batch
from .pipeline.options import Options

# reference flags outside the slice -> the ROADMAP item that ports them
NOT_PORTED = {
    "use_constraint": ("-c/--use-constraint", "queue 1 item 1 (single-pair "
                       "exact path and constraint masks)"),
    "force_constraint": ("--force-constraint", "queue 1 item 1"),
    "rip": ("-r/--rip", "queue 1 item 1"),
    "acc_max": ("--acc-max", "queue 1 item 1"),
    "acc_max_ss": ("--acc-max-ss", "queue 1 item 1"),
    "acc_num": ("--acc-num", "queue 1 item 1"),
    "no_pk": ("--no-pk", "queue 1 item 1"),
    "allow_isolated": ("--allow-isolated", "queue 1 item 1"),
    "contrafold": ("--contrafold", "queue 1 item 3 (CONTRAfold)"),
    "contraduplex": ("--contraduplex", "queue 1 item 3 (CONTRAfold)"),
    "param_file": ("-P/--param-file", "queue 1 item 1"),
    "no_bl": ("--no-bl", "queue 1 item 1"),
    "mesh": ("--mesh", "queue 1 item 4 (multi-GPU)"),
    "ckpt_dir": ("--ckpt-dir", "queue 1 item 2 (ckpt_dir resume)"),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ractip-tpu-torch",
        description="RactIP on PyTorch + CUDA: RNA-RNA interaction "
                    "prediction (port of ractip_tpu: the default model and "
                    "the pure-duplex model).")
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
    ap.add_argument("--max-w", type=int, default=15,
                    help="maximum length of accessible regions")
    ap.add_argument("--min-w", type=int, default=5,
                    help="minimum length of accessible regions")
    ap.add_argument("--zscore", type=int, default=0, choices=(0, 1, 2, 12),
                    help="z-score via dishuffling (1=1st, 2=2nd, 12=both)")
    ap.add_argument("--num-shuffling", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=256,
                    help="device batch chunk size")
    ap.add_argument("-e", "--show-energy", action="store_true",
                    help="free energy of the predicted joint structure")
    ap.add_argument("--duplex", action="store_true",
                    help="pure-duplex hybridization model (pf_duplex) in "
                         "place of the cofold")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    flag = lambda *names, **kw: ap.add_argument(*names, help=argparse.SUPPRESS,
                                                **kw)
    flag("-c", "--use-constraint", action="store_true")
    flag("--force-constraint", action="store_true")
    flag("-r", "--rip", default=None)
    flag("--acc-max", action="store_true")
    flag("--acc-max-ss", action="store_true")
    flag("--acc-num", type=int, default=None)
    flag("--no-pk", action="store_true")
    flag("--allow-isolated", action="store_true")
    flag("--contrafold", action="store_true")
    flag("--contraduplex", action="store_true")
    flag("-P", "--param-file", default=None)
    flag("--no-bl", action="store_true")
    flag("--mesh", action="store_true")
    flag("--ckpt-dir", default=None)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    for dest, (name, item) in NOT_PORTED.items():
        if getattr(args, dest) not in (None, False):
            print(f"ractip-tpu-torch: {name} is not ported yet "
                  f"(ROADMAP.md {item})", file=sys.stderr)
            return 2
    if len(args.fasta) >= 2:
        fa1 = load_fasta(args.fasta[0])[0]
        fa2 = load_fasta(args.fasta[1])[0]
    else:
        recs = load_fasta(args.fasta[0])
        if len(recs) < 2:
            print(f"{args.fasta[0]}: Format error", file=sys.stderr)
            return 1
        fa1, fa2 = recs[0], recs[1]
    opts = Options(alpha=args.alpha, beta=args.beta, th_ss=args.fold_th,
                   th_hy=args.hybridize_th, th_ac=args.acc_th,
                   max_w=args.max_w, min_w=args.min_w, zscore=args.zscore,
                   num_shuffling=args.num_shuffling, seed=args.seed,
                   show_energy=args.show_energy, use_pf_duplex=args.duplex)
    params = get_default_params()

    if args.zscore in (1, 2, 12):
        z, zs, st = zscore_batch(fa1, fa2, opts, params, chunk=args.chunk,
                                 device=args.device)
        r1, r2 = st["brackets"]
        print(f">{fa1.name}\n{fa1.seq}\n{r1}")
        print(f">{fa2.name}\n{fa2.seq}\n{r2}")
        if args.show_energy:
            print(f"(E: JS= {st['e']:g}, JS-S1-S2= {st['es']:g})")
        print(f"z-score: {z:g}, {zs:g}")
        return 0

    res = predict_batch(params, [(fa1.seq, fa2.seq)], opts, chunk=1,
                        want_energy=args.show_energy, device=args.device)
    print(f">{fa1.name}\n{fa1.seq}\n{res.r1[0]}")
    print(f">{fa2.name}\n{fa2.seq}\n{res.r2[0]}")
    if args.show_energy:
        e1, e2, e3, e1s, e2s = res.energies[0]
        parts = lambda ps: f"{ps[0]:g}" + "".join(
            ("+" if p >= 0 else "") + f"{p:g}" for p in ps[1:])
        print(f"(E: JS= {e1 + e2 + e3:g} = {parts([e1, e2, e3])}, "
              f"S1+S2= {e1s + e2s:g} = {parts([e1s, e2s])})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
