"""Copy of movi_tpu/constants.py: the port keeps its own, so it imports nothing
of the JAX package.

Global constants for movi_tpu.

These mirror the reference semantics (Movi) so that query
outputs are bit-identical:
  - END_CHARACTER / THRBYTES / null-read constants: include/utils.hpp:162-169
  - SEPARATOR: include/commons.hpp:63-64
  - MAX_RUN_LENGTH per index mode: include/move_row_configs.hpp
  - alphamap_3: src/utils.cpp:5-8
"""

import numpy as np

# The BWT terminator byte emitted by the suffix-array builder (utils.hpp:162).
END_CHARACTER = 0

# Separator character placed between documents when --separators is used
# (commons.hpp:63).
SEPARATOR = ord("%")

THRBYTES = 5
MIN_MATCHING_LENGTH = 3
NULL_READ_CHUNK = 150
NUM_NULL_READS = 800
NULL_READ_BOUND = 1000
UNCLASSIFIED_THRESHOLD = 0.4

# alphamap_3[row_char_index][other_char_index] -> threshold slot in {0,1,2}
# (3 = own character, unused).  Mirrors src/utils.cpp:5-8.
ALPHAMAP_3 = np.array(
    [[3, 0, 1, 2],
     [0, 3, 1, 2],
     [0, 1, 3, 2],
     [0, 1, 2, 3]],
    dtype=np.int32,
)

# Index modes.  Mode names and MAX_RUN_LENGTH follow
# include/move_row_configs.hpp and src/utils.cpp:10-39.
MODE_LARGE = "large"                    # MODE 0, 12 B/row, value thresholds
MODE_CONSTANT = "constant"              # MODE 1, 24 B/row, next pointers
MODE_BLOCKED = "blocked"                # MODE 2, 6 B/row
MODE_REGULAR = "regular"                # MODE 3, 8 B/row, no thresholds
MODE_SPLIT = "split"                    # MODE 4, 12 B/row
MODE_SAMPLED = "sampled"                # MODE 5, 3 B/row (tally)
MODE_REGULAR_THR = "regular-thresholds" # MODE 6, 8 B/row, split thresholds
MODE_SAMPLED_THR = "sampled-thresholds" # MODE 7, 3 B/row
MODE_BLOCKED_THR = "blocked-thresholds" # MODE 8, 6 B/row

# mode -> (mode_number, max_run_length, uses_thresholds, split_thresholds)
MODE_INFO = {
    MODE_LARGE:       (0, 65535, True,  False),
    MODE_CONSTANT:    (1, 65535, True,  False),
    MODE_BLOCKED:     (2, 1023,  False, False),
    MODE_REGULAR:     (3, 4095,  False, False),
    MODE_SPLIT:       (4, 65535, True,  False),
    MODE_SAMPLED:     (5, 1023,  False, False),
    MODE_REGULAR_THR: (6, 2047,  True,  True),
    MODE_SAMPLED_THR: (7, 511,   True,  True),
    MODE_BLOCKED_THR: (8, 1023,  True,  True),
}

# Bytes per packed row in the reference layouts (move_row.hpp:104-120),
# used for HBM-size accounting.
MODE_ROW_BYTES = {
    MODE_LARGE: 12,
    MODE_CONSTANT: 24,
    MODE_BLOCKED: 6,
    MODE_REGULAR: 8,
    MODE_SPLIT: 12,
    MODE_SAMPLED: 3,
    MODE_REGULAR_THR: 8,
    MODE_SAMPLED_THR: 3,
    MODE_BLOCKED_THR: 6,
}

DNA = b"ACGT"
COMPLEMENT = {ord("A"): ord("T"), ord("C"): ord("G"),
              ord("G"): ord("C"), ord("T"): ord("A"),
              ord("#"): ord("#"), SEPARATOR: SEPARATOR}


def complement_char(c: int) -> int:
    """Mirror utils.cpp:87-91 (unknown chars map to 'A')."""
    if c == ord("#"):
        return ord("#")
    if c == ord("A"):
        return ord("T")
    if c == ord("C"):
        return ord("G")
    if c == ord("G"):
        return ord("C")
    return ord("A")
