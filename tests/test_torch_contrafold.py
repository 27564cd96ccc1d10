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

And against tests/data/torch_port_golden_contrafold_decode.json
(tools/make_torch_decode_golden.py, JAX with x64), every entry at L <= 64
(the longer ones, L = 96-160, are held on the card by chip_smoke.py's phase
`rest`, which holds every entry): cf_viterbi (score within 1e-9 relative,
mapping identical) and cf_mea at gamma 6 and 1 (mappings identical) of the
corpus strands; cf_logz, the 64 largest cf_base_pair_probs and cf_viterbi
under a seeded `allow` mask and under seeded helix-length weights (log Z
and scores within 1e-9 relative, probabilities within 1e-8);
cf_loss_augmented_viterbi and cf_margin against the curated structures at
fp = fn = 1 and 0.7 (scores within 1e-9 relative, 1e-9 absolute near 0;
mappings identical); 200 cf_stochastic_traceback samples (seed 42),
identical.
"""

import json
import os

import numpy as np
import pytest
import torch

from ractip_tpu_torch import cli
from ractip_tpu_torch.evaluate.corpus import corpus_pairs
from ractip_tpu_torch.ops.contraduplex import cd_hybrid_probs, cd_logz
from ractip_tpu_torch.ops.contrafold import (
    cf_base_pair_probs, cf_helix_features, cf_logz,
    cf_loss_augmented_viterbi, cf_margin, cf_mea, cf_stochastic_traceback,
    cf_unpaired_probs, cf_viterbi)
from ractip_tpu_torch.ops.seq import encode
from ractip_tpu_torch.params.tables import get_default_params
from ractip_tpu_torch.pipeline.ractip import Posteriors

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "data",
                       "torch_port_golden_contrafold.json")) as _fh:
    GOLD = json.load(_fh)
with open(os.path.join(ROOT, "tests", "data",
                       "torch_port_golden_contrafold_decode.json")) as _fh:
    DECODE = json.load(_fh)
DECODE_MAX_L = 64           # longer entries: chip_smoke.py, phase `rest`
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


def _close(got, want):
    """Within 1e-9 relative (absolute below 1)."""
    return abs(float(got) - want) <= TOL * max(abs(want), 1.0)


def _allow(e):
    L = e["L"]
    bits = np.unpackbits(np.frombuffer(bytes.fromhex(e["allow"]), np.uint8))
    return bits[:L * L].reshape(L, L).astype(bool)


def _decode_matches_golden():
    """The decoding and max-margin functions against the decode golden."""
    short = {k: [e for e in DECODE[k] if e["L"] <= DECODE_MAX_L]
             for k in ("viterbi", "allow", "helix", "loss", "samples")}
    assert all(short.values()), short
    for e in short["viterbi"]:
        S, n = encode(e["seq"], e["L"]), e["n"]
        score, mapping = cf_viterbi(S, n, device="cpu")
        assert _close(score, e["score"]), (e["pair"], e["strand"])
        assert mapping.dtype == torch.int32
        assert mapping.tolist() == e["mapping"]
        bpp = cf_base_pair_probs(S, n, device="cpu")
        assert cf_mea(bpp, n, 6.0).tolist() == e["mea6"]
        assert cf_mea(bpp, n, 1.0).tolist() == e["mea1"]
    for key in ("allow", "helix"):
        for e in short[key]:
            S, n = encode(e["seq"], e["L"]), e["n"]
            kw = (dict(allow=_allow(e)) if key == "allow" else
                  dict(helix=cf_helix_features(e["length_at_least"],
                                               e["isolated"])))
            assert _close(cf_logz(S, n, device="cpu", **kw), e["logz"])
            np.testing.assert_allclose(
                *_top(cf_base_pair_probs(S, n, device="cpu", **kw),
                      e["bpp_top"]), rtol=0, atol=1e-8)
            score, mapping = cf_viterbi(S, n, device="cpu", **kw)
            assert _close(score, e["score"]), (key, e["pair"])
            assert mapping.tolist() == e["mapping"]
    for e in short["loss"]:
        S, n = encode(e["seq"], e["L"]), e["n"]
        for r in e["runs"]:
            aug, score, mapping = cf_loss_augmented_viterbi(
                S, n, e["true"], r["fp"], r["fn"], device="cpu")
            assert _close(aug, r["augmented"]) and _close(score, r["score"])
            assert mapping.tolist() == r["mapping"]
            assert _close(cf_margin(S, n, e["true"], r["fp"], r["fn"],
                                    device="cpu"), r["margin"])
    for e in short["samples"]:
        got = cf_stochastic_traceback(encode(e["seq"], e["L"]), e["n"],
                                      len(e["samples"]), seed=e["seed"],
                                      device="cpu")
        assert [m.tolist() for m in got] == e["samples"]


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
    _decode_matches_golden()
