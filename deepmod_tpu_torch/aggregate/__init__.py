from .summarize import (
    PositionCounts,
    accumulate_base_map,
    write_bed,
    bed_line,
    merge_counts,
)
