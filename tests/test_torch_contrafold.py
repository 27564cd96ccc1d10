"""Port CONTRAfold model (ractip_tpu_torch.ops.contrafold, ops.contraduplex,
the CONTRAfold branch of pipeline.ractip.Posteriors) vs the JAX package.

Held against tests/data/torch_port_golden_contrafold.json, which
tools/make_torch_contrafold_golden.py wrote from the JAX package on the CPU
with x64 on, so no JAX is compiled here:

  * cf_logz, cf_base_pair_probs and cf_unpaired_probs of seeded strands
    padded to a bucket (n < L), both models, and cd_logz and
    cd_hybrid_probs of two seeded padded pairs: log Z within 1e-9
    relative, every probability within 1e-9 absolute (the rest of the
    matrices exactly 0);
  * Posteriors under --contrafold on Tar-Tarstar and under --contraduplex
    --min-w 1 (accessibility off, so the pair hybridizes) on R1inv-R2inv:
    each strand's pu and 64 largest pair probabilities (and the CRF duplex
    engine's 64 largest hybridization probabilities) within 1e-9;
  * the same cases through the CLI's routing (cli.run_pair): brackets
    identical, objective within 1e-4, energies within 1e-6 kcal/mol.
"""

import json
import os

import numpy as np
import pytest
import torch

from ractip_tpu_torch import cli
from ractip_tpu_torch.evaluate.corpus import corpus_pairs
from ractip_tpu_torch.ops.contraduplex import cd_hybrid_probs, cd_logz
from ractip_tpu_torch.ops.contrafold import (cf_base_pair_probs, cf_logz,
                                             cf_unpaired_probs)
from ractip_tpu_torch.ops.seq import encode
from ractip_tpu_torch.params.tables import get_default_params
from ractip_tpu_torch.pipeline.ractip import Posteriors

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "data",
                       "torch_port_golden_contrafold.json")) as _fh:
    GOLD = json.load(_fh)
PAIRS = {name: (fa1, fa2) for name, fa1, fa2 in corpus_pairs()}
TOL = 1e-9
CASES = (("Tar-Tarstar", ["--contrafold", "-e"]),
         ("R1inv-R2inv", ["--contraduplex", "--min-w", "1", "-e"]))


def _dense(entries, shape):
    m = np.zeros(shape)
    for i, j, p in entries:
        m[i, j] = p
    return m


def _top(m, top):
    """The port's values at the golden's 64 largest entries, and the
    golden's values."""
    m = np.asarray(m)
    return (np.array([m[i, j] for i, j, _ in top]),
            np.array([p for _, _, p in top]))


def _golden(pair, flags):
    return next(e for e in GOLD["corpus"]
                if e["pair"] == pair and e["flags"] == flags)


def test_contrafold_matches_golden():
    for e in GOLD["strands"]:
        S, n, m = encode(e["seq"], e["L"]), e["n"], e["model"]
        z = float(cf_logz(S, n, m, device="cpu"))
        assert abs(z - e["logz"]) <= TOL * abs(e["logz"]), (e["seed"], z)
        bpp = cf_base_pair_probs(S, n, m, device="cpu")
        assert bpp.dtype == torch.float64
        np.testing.assert_allclose(bpp.numpy(),
                                   _dense(e["bpp"], (e["L"], e["L"])),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(cf_unpaired_probs(bpp).numpy(), e["pu"],
                                   rtol=0, atol=TOL)
    for e in GOLD["duplexes"]:
        S1, S2 = encode(e["seq1"], e["L1"]), encode(e["seq2"], e["L2"])
        args = (S1, S2, e["n1"], e["n2"])
        z = float(cd_logz(*args, device="cpu"))
        assert abs(z - e["logz"]) <= TOL * abs(e["logz"]), (e["seed"], z)
        np.testing.assert_allclose(
            cd_hybrid_probs(*args, device="cpu").numpy(),
            _dense(e["hp"], (e["L1"], e["L2"])), rtol=0, atol=TOL)

    params = get_default_params()
    for pair, flags in CASES:
        e = _golden(pair, flags)
        fa1, fa2 = PAIRS[pair]
        args = cli.build_parser().parse_args(["a", "b", "--device", "cpu"]
                                             + flags)
        acc = cli.options_from_args(args).solver_cfg().accessibility
        post = Posteriors(params, fa1.seq, fa2.seq, args.max_w, acc,
                          use_contrafold=args.contrafold,
                          use_contraduplex=args.contraduplex, device="cpu")
        for g, bpp, pu, fa in zip(e["strands"], (post.bpp1, post.bpp2),
                                  (post.pu1, post.pu2), (fa1, fa2)):
            assert bpp.shape == (g["L"], g["L"])
            np.testing.assert_allclose(*_top(bpp, g["bpp_top"]), rtol=0,
                                       atol=TOL)
            if g["pu"] is None:
                assert pu is None and not acc
            else:
                assert pu.shape == (g["L"], 16)
                np.testing.assert_allclose(pu[:, 1], g["pu"], rtol=0,
                                           atol=TOL)
                assert not pu[:, 0].any() and not pu[:, 2:].any()
            z = float(cf_logz(encode(fa.seq, g["L"]), len(fa.seq),
                              device="cpu"))
            assert abs(z - g["logz"]) <= TOL * abs(g["logz"])
        if args.contraduplex:
            np.testing.assert_allclose(*_top(post.hp, e["hp_top"]), rtol=0,
                                       atol=TOL)
        r1, r2, obj, ee, zs = cli.run_pair(args, fa1, fa2)
        assert (r1, r2) == (e["r1"], e["r2"]), (pair, flags)
        assert obj == pytest.approx(e["objective"], abs=1e-4)
        got = [ee[k] for k in ("e1", "e2", "e3", "e1s", "e2s")]
        np.testing.assert_allclose(got, e["energies"], rtol=0, atol=1e-6)
        assert zs is None
