"""Vienna-format energy-parameter file support (the reference's -P flag).

A copy of ractip_tpu/params/vienna_par.py (numpy only) on the port's
params/tables.py, kept in the port so that it imports nothing of the JAX
package.

The reference forwards -P straight to ViennaRNA's read_parameter_file
(reference src/ractip.cpp:63, :1568-1569), which overwrites the global 37C
tables section by section.  This module reads the same "## RNAfold parameter
file v2.0" text format into an EnergyParams override, and can write our
tables back out in that format (used by the round-trip tests, since ViennaRNA
itself is not present in this environment).

Conventions (matching ViennaRNA's file format):
  * all energies in dekacal/mol (10 cal/mol) at 37C
  * pair-type order CG GC GU UG AU UA NN (indices 1..7)
  * nucleotide order N A C G U (indices 0..4)
  * "INF" marks forbidden entries
  * enthalpy sections ("*_dH") and sections our 37C model does not use
    (exterior/multi mismatches, Hexaloops, ...) are parsed and ignored
  * v1.x section aliases (stack_energies, int11_energies, ...) are accepted
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from ..constants import INF, NBPAIRS
from .tables import EnergyParams, encode_kmer

# canonical section name -> aliases seen in v1.x files
_ALIASES = {
    "stack": ("stack_energies",),
    "mismatch_hairpin": (),
    "mismatch_interior": (),
    "dangle5": (),
    "dangle3": (),
    "int11": ("int11_energies",),
    "int21": ("int21_energies",),
    "int22": ("int22_energies",),
    "hairpin": (),
    "bulge": (),
    "interior": ("internal_loop",),
    "ML_params": (),
    "NINIO": (),
    "Misc": (),
    "Tetraloops": (),
}
_CANON = {}
for k, al in _ALIASES.items():
    _CANON[k.lower()] = k
    for a in al:
        _CANON[a.lower()] = k


def _tokenize(text: str):
    """section name -> list of raw tokens (comments stripped)."""
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    sections: dict[str, list[str]] = {}
    cur = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("##"):
            continue
        if line.startswith("#"):
            name = line[1:].strip()
            cur = sections.setdefault(name, [])
            continue
        if cur is not None:
            cur.extend(line.split())
    return sections


def _ints(tokens: list[str]) -> np.ndarray:
    out = []
    for t in tokens:
        if t.upper() in ("INF", "NST"):
            out.append(INF)
        elif t.upper() == "DEF":
            out.append(-50)
        else:
            out.append(int(round(float(t))))
    return np.array(out, dtype=np.int64)


def _reshape_pairs(vals: np.ndarray, trailing: tuple[int, ...],
                   name: str) -> np.ndarray:
    """Reshape a per-pair-type table, inferring whether the file includes the
    index-0 ("no pair") rows (v2.0 writes 1..7 only; some writers emit 0..7)."""
    t = int(np.prod(trailing, dtype=np.int64)) if trailing else 1
    for npair in (NBPAIRS, NBPAIRS + 1):
        if vals.size == npair ** _npair_axes(name) * t:
            shape = (npair,) * _npair_axes(name) + trailing
            a = vals.reshape(shape)
            if npair == NBPAIRS + 1:   # drop the index-0 slices
                a = a[(slice(1, None),) * _npair_axes(name)]
            return a
    raise ValueError(f"section '{name}': unexpected value count {vals.size}")


def _npair_axes(name: str) -> int:
    return 2 if name in ("stack", "int11", "int21", "int22") else 1


@dataclasses.dataclass
class ParsedPar:
    """Raw parsed tables, indices as in our EnergyParams (padded type 0)."""

    tables: dict
    ignored: list[str]


def parse_par(text: str) -> ParsedPar:
    sections = _tokenize(text)
    tables: dict = {}
    ignored: list[str] = []
    for raw_name, toks in sections.items():
        name = _CANON.get(raw_name.lower())
        if name is None or raw_name.endswith("_dH"):
            ignored.append(raw_name)
            continue
        if name == "Tetraloops":
            keys, bonus = [], []
            for i in range(0, len(toks) - 1, 3 if len(toks) % 3 == 0 else 2):
                seq = toks[i]
                if not re.fullmatch(r"[ACGUacgu]{6}", seq):
                    break
                keys.append(encode_kmer(seq.upper()))
                bonus.append(int(float(toks[i + 1])))
            tables["tetraloop_keys"] = np.array(keys, np.int32)
            tables["tetraloop_bonus"] = np.array(bonus, np.int32)
            continue
        vals = _ints(toks)
        if name == "stack":
            tables["stack"] = _reshape_pairs(vals, (), "stack")
        elif name == "mismatch_hairpin":
            tables["mismatch_h"] = _reshape_pairs(vals, (5, 5), name)
        elif name == "mismatch_interior":
            tables["mismatch_i"] = _reshape_pairs(vals, (5, 5), name)
        elif name in ("dangle5", "dangle3"):
            tables[name] = _reshape_pairs(vals, (5,), name)
        elif name == "int11":
            tables["int11"] = _reshape_pairs(vals, (5, 5), name)
        elif name == "int21":
            tables["int21"] = _reshape_pairs(vals, (5, 5, 5), name)
        elif name == "int22":
            # v2.0 writes nucleotide indices 1..4 only
            for nuc in (4, 5):
                for npair in (NBPAIRS, NBPAIRS + 1):
                    if vals.size == npair * npair * nuc ** 4:
                        a = vals.reshape((npair, npair) + (nuc,) * 4)
                        if npair == NBPAIRS + 1:
                            a = a[1:, 1:]
                        if nuc == 5:
                            a = a[:, :, 1:, 1:, 1:, 1:]
                        tables["int22"] = a
            if "int22" not in tables:
                raise ValueError(f"int22: unexpected count {vals.size}")
        elif name in ("hairpin", "bulge", "interior"):
            key = "internal" if name == "interior" else name
            tables[key] = vals[:31]
        elif name == "ML_params":
            # v2.0: cu cu_dH cc cc_dH ci ci_dH; v1.x: cu cc ci
            v = vals
            if v.size >= 6:
                tables["ml"] = (int(v[0]), int(v[2]), int(v[4]))
            elif v.size >= 3:
                tables["ml"] = (int(v[0]), int(v[1]), int(v[2]))
        elif name == "NINIO":
            # v2.0: m m_dH max; v1.x: m max
            if vals.size >= 3:
                tables["ninio"] = (int(vals[0]), int(vals[2]))
            elif vals.size == 2:
                tables["ninio"] = (int(vals[0]), int(vals[1]))
        elif name == "Misc":
            # v2.0: DuplexInit DuplexInit_dH TerminalAU TerminalAU_dH [lxc]
            f = [float(t) for t in toks]
            if len(f) >= 5:
                tables["misc"] = dict(duplex_init=int(f[0]),
                                      terminal_au=int(f[2]), lxc=f[4])
            elif len(f) == 4:
                tables["misc"] = dict(duplex_init=int(f[0]),
                                      terminal_au=int(f[1]), lxc=f[3])
            elif len(f) >= 2:
                tables["misc"] = dict(duplex_init=int(f[0]),
                                      terminal_au=int(f[1]),
                                      lxc=f[-1] if f[-1] != int(f[-1]) else None)
    return ParsedPar(tables=tables, ignored=ignored)


def _pad_t(a: np.ndarray, axes: int, fill: int) -> np.ndarray:
    """Pad pair-type axes (leading `axes` dims) with an index-0 slice."""
    pad = [(1, 0)] * axes + [(0, 0)] * (a.ndim - axes)
    return np.pad(a, pad, constant_values=fill)


def apply_par(base: EnergyParams, parsed: ParsedPar) -> EnergyParams:
    """EnergyParams with sections present in the file overriding `base`."""
    t = parsed.tables
    kw = {}
    if "stack" in t:
        kw["stack"] = _pad_t(t["stack"], 2, INF).astype(np.int32)
    if "mismatch_h" in t:
        kw["mismatch_h"] = _pad_t(t["mismatch_h"], 1, 0).astype(np.int32)
    if "mismatch_i" in t:
        kw["mismatch_i"] = _pad_t(t["mismatch_i"], 1, 0).astype(np.int32)
    if "dangle5" in t:
        kw["dangle5"] = _pad_t(t["dangle5"], 1, INF).astype(np.int32)
    if "dangle3" in t:
        kw["dangle3"] = _pad_t(t["dangle3"], 1, INF).astype(np.int32)
    if "int11" in t:
        kw["int11"] = _pad_t(t["int11"], 2, INF).astype(np.int32)
    if "int21" in t:
        kw["int21"] = _pad_t(t["int21"], 2, INF).astype(np.int32)
    if "int22" in t:
        a = np.pad(t["int22"], ((0, 0), (0, 0)) + ((1, 0),) * 4,
                   constant_values=0)
        kw["int22"] = _pad_t(a, 2, INF).astype(np.int32)
    for k in ("hairpin", "bulge", "internal"):
        if k in t:
            a = np.asarray(t[k], np.int64)
            if a.size < 31:
                a = np.pad(a, (0, 31 - a.size), constant_values=a[-1])
            kw[k] = a.astype(np.int32)
    if "ml" in t:
        kw["ml_base"], kw["ml_closing"], kw["ml_intern"] = t["ml"]
    if "ninio" in t:
        kw["ninio_m"], kw["max_ninio"] = t["ninio"]
    if "misc" in t:
        m = t["misc"]
        kw["duplex_init"] = m["duplex_init"]
        kw["terminal_au"] = m["terminal_au"]
        if m.get("lxc") is not None:
            kw["lxc"] = m["lxc"]
    if "tetraloop_keys" in t:
        kw["tetraloop_keys"] = t["tetraloop_keys"]
        kw["tetraloop_bonus"] = t["tetraloop_bonus"]
    return dataclasses.replace(base, **kw)


def load_param_file(path: str, base: EnergyParams) -> EnergyParams:
    with open(path) as fh:
        text = fh.read()
    if not text.lstrip().startswith("## RNAfold parameter file"):
        raise ValueError(f"{path}: not a Vienna parameter file")
    return apply_par(base, parse_par(text))


def _fmt_block(a: np.ndarray, per_line: int = 25) -> str:
    flat = a.reshape(-1)
    toks = ["INF" if v >= INF else str(int(v)) for v in flat]
    return "\n".join(" ".join(toks[i:i + per_line])
                     for i in range(0, len(toks), per_line))


def write_par(params: EnergyParams) -> str:
    """Our tables in Vienna v2.0 text format (37C energies; dH written as 0)."""
    from ..constants import BASES

    def interleave0(a):  # pair each 37C value with a 0 enthalpy? no -- v2.0
        return a         # keeps dH in separate *_dH sections, omitted here

    out = ["## RNAfold parameter file v2.0", ""]

    def sec(name, a):
        out.append(f"# {name}")
        out.append(_fmt_block(a))
        out.append("")

    sec("stack", params.stack[1:, 1:])
    sec("mismatch_hairpin", params.mismatch_h[1:])
    sec("mismatch_interior", params.mismatch_i[1:])
    sec("dangle5", params.dangle5[1:])
    sec("dangle3", params.dangle3[1:])
    sec("int11", params.int11[1:, 1:])
    sec("int21", params.int21[1:, 1:])
    sec("int22", params.int22[1:, 1:, 1:, 1:, 1:, 1:])
    sec("hairpin", params.hairpin)
    sec("bulge", params.bulge)
    sec("interior", params.internal)
    out.append("# ML_params")
    out.append(f"{params.ml_base} 0 {params.ml_closing} 0 {params.ml_intern} 0")
    out.append("")
    out.append("# NINIO")
    out.append(f"{params.ninio_m} 0 {params.max_ninio}")
    out.append("")
    out.append("# Misc")
    out.append(f"{params.duplex_init} 0 {params.terminal_au} 0 "
               f"{params.lxc:.6g}")
    out.append("")
    out.append("# Tetraloops")
    for k, b in zip(params.tetraloop_keys, params.tetraloop_bonus):
        digits = []
        v = int(k)
        for _ in range(6):
            digits.append(v % 5)
            v //= 5
        seq = "".join(BASES[d] for d in reversed(digits))
        out.append(f"{seq} {int(b)} 0")
    out.append("")
    out.append("#END")
    return "\n".join(out)
