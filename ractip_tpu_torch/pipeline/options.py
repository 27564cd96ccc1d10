"""Pipeline options: SolverConfig plus the z-score and model switches.

Port of ractip_tpu/pipeline/ractip.py::Options (:38-58), same fields.
"""

from __future__ import annotations

import dataclasses

from ..solver.candidates import SolverConfig


@dataclasses.dataclass(frozen=True)
class Options(SolverConfig):
    """SolverConfig + run options (reference src/ractip.ggo)."""

    zscore: int = 0                 # 0 | 1 | 2 | 12
    num_shuffling: int = 1000
    seed: int = 0
    show_energy: bool = False
    use_constraint: bool = False
    use_pf_duplex: bool = False     # hidden --duplex flag: pure-duplex model
    use_contrafold: bool = False    # --contrafold: learned-CRF scoring model
    use_contraduplex: bool = False  # --contraduplex: CRF DuplexEngine

    def solver_cfg(self) -> SolverConfig:
        return SolverConfig(**{f.name: getattr(self, f.name)
                               for f in dataclasses.fields(SolverConfig)})
