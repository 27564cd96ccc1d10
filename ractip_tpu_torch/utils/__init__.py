from .timing import StageTimer, profile_trace
from .records import PairRecord, write_records, read_records
from .checkpoint import SweepCheckpoint

__all__ = ["StageTimer", "profile_trace", "PairRecord", "write_records",
           "read_records", "SweepCheckpoint"]
