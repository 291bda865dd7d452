from .common import (
    OUTPUT_DEBUG,
    OUTPUT_INFO,
    OUTPUT_WARNING,
    OUTPUT_ERROR,
    G_ACGT,
    BASE_TO_INDEX,
    COMPLEMENT,
    complement_base,
    complement_seq,
    reverse_complement,
    format_folder,
    ErrorCensus,
)
