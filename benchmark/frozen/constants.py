# Frozen copy of airmodes_torch/constants.py at commit 8b1fb463eba6: part of
# the benchmark's yardstick, which later changes to the program leave as
# it is. Only its imports were changed.
"""Mode S physical-layer and protocol constants.

Behavioral parity targets (reference: gr-air-modes; see SURVEY.md §0/§2.1):
  - chip period 0.5 us -> canonical channel rate 2 Msps (1 sample/chip)
  - preamble: 4 pulses at chip offsets {0, 2, 7, 9} within an 8 us
    (16-chip) preamble window; remaining chips are quiet
    (ref: lib/preamble_impl.cc)
  - data: 56 or 112 bits, 1 us/bit, PPM (pulse in first chip = 1)
  - CRC-24 generator polynomial 0x1FFF409 (ref: lib/slicer_impl.cc)

A copy of `airmodes.constants`: the port imports nothing of the JAX package.
"""

# --- timing -----------------------------------------------------------------
CHIP_RATE = 2_000_000          # chips/s (0.5 us per chip)
CHIPS_PER_BIT = 2              # PPM: two chips per data bit
PREAMBLE_CHIPS = 16            # 8 us preamble window
MAX_FRAME_BITS = 112
SHORT_FRAME_BITS = 56
MAX_FRAME_CHIPS = MAX_FRAME_BITS * CHIPS_PER_BIT          # 224
MAX_EVENT_CHIPS = PREAMBLE_CHIPS + MAX_FRAME_CHIPS        # 240 chips = 120 us

# Preamble pulse / quiet chip positions (chip offsets from preamble start).
PREAMBLE_PULSE_CHIPS = (0, 2, 7, 9)
PREAMBLE_QUIET_CHIPS = (1, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15)

# --- CRC --------------------------------------------------------------------
CRC_GENERATOR = 0x1FFF409      # 25-bit generator polynomial
CRC_BITS = 24

# --- downlink formats ---------------------------------------------------------
# Long (112-bit) downlink formats. All DF >= 16 are 112 bits in Mode S;
# the reference handles DF 16/17/20/21 (24 partial) as long frames
# (ref: lib/slicer_impl.cc DF->length dispatch).
def frame_bits_for_df(df: int) -> int:
    return MAX_FRAME_BITS if df >= 16 else SHORT_FRAME_BITS


# DF17 callsign 6-bit character map (ref: python/parse.py charmap).
CALLSIGN_CHARMAP = (
    "#ABCDEFGHIJKLMNOPQRSTUVWXYZ#####"
    "_###############0123456789######"
)

# --- slicer status codes (device -> host detection table) --------------------
STATUS_CRC_OK = 0        # syndrome passes the per-DF acceptance rule
STATUS_CORRECTED_1 = 1   # DF17 brute-force single low-confidence bit flip
STATUS_CORRECTED_2 = 2   # DF17 brute-force two-bit low-confidence flip
STATUS_ADDR = 3          # AP overlaid with ICAO: syndrome *is* the address
STATUS_FAIL = 4          # uncorrectable

# DFs whose AP field is parity XOR ICAO address (syndrome == address).
AP_ADDRESS_DFS = (0, 4, 5, 16, 20, 21, 24)

# DF18 CF=1/5 carry non-ICAO (anonymous/TIS-B track-file) addresses: they
# are namespaced with this bit so NO ICAO-keyed consumer (CPR cache,
# dashboard, icao_gate training, per-ICAO output state) can collide an
# anonymous target with a real aircraft whose 24-bit address matches.
# Display convention: "~xxxxxx" (what dump1090/readsb use for non-ICAO).
ANON_ICAO_BIT = 1 << 24
