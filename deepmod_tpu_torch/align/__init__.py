from .sam import SamRecord, parse_sam_line, filter_best_alignments
from .cigar import BaseMapResult, expand_alignment, BASE_MAP_DTYPE
from .aligner import get_aligner, AlignerBase
