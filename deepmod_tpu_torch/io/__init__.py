from .fasta import FastaReference, read_fasta, write_fasta, build_fai_index
from .fast5 import Fast5Read, read_fast5_file, read_fast5_batch
from .events import (
    collapse_events_v1,
    collapse_events_v2,
    resegment_events,
    move_table_events,
    EVENT_DTYPE,
)
from .signal_norm import normalize_signal, event_mean_std
